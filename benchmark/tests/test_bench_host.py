"""The host's readings beside a run's metrics: the set-up's phases add up
to the time since the start, and a busy stretch reads one CPU."""

from __future__ import annotations

import time

from benchmark import host


def test_phases_add_up_to_the_time_since_start():
    start = host.now()
    phases = host.Phases(start)
    time.sleep(0.02)
    phases.mark("a")
    time.sleep(0.01)
    phases.mark("b")
    phases.mark("a")
    assert list(phases.split) == ["a", "b"]
    assert abs(sum(phases.split.values()) - (host.now() - start)) < 0.01
    assert phases.split["a"] >= 0.02 and phases.split["b"] >= 0.01


def test_cpu_readings_over_a_busy_stretch():
    before = host.snapshot()
    t = time.perf_counter()
    while time.perf_counter() - t < 0.1:
        pass
    out = host.over(before, host.snapshot())
    assert 0.5 < out["process_cpus"] < 1.5 and out["cpus"] >= 1
