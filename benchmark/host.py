"""What the host did in a run: the set-up's phases and this process's CPU
over the measured window. Reported beside the metrics, never compared or
bounded, so that a run that reads far off can be told from a change to
the program: a slow run whose process used no more CPU, and whose
dispatcher spent no more CPU time a batch, was slowed from outside.
"""

from __future__ import annotations

import os
import resource
import time


def now() -> float:
    """The clock the set-up time is taken on (it counts from boot, so
    the process's start time from /proc can be read on it)."""
    return time.clock_gettime(time.CLOCK_BOOTTIME)


class Phases:
    """Seconds of each phase of the set-up, in order, each from the end
    of the one before (the first from the process's start)."""

    def __init__(self, start: float):
        self.last = start
        self.split = {}

    def mark(self, name: str):
        t = now()
        self.split[name] = self.split.get(name, 0.0) + t - self.last
        self.last = t


def snapshot():
    """(wall, this process's CPU seconds)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return time.perf_counter(), ru.ru_utime + ru.ru_stime


def over(a, b) -> dict:
    """The machine's CPUs, and how many of them this process kept busy
    between two snapshots."""
    return {"cpus": os.cpu_count(),
            "process_cpus": (b[1] - a[1]) / (b[0] - a[0])}
