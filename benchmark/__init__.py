"""The benchmark of ``sketchedit_tpu_torch`` on one NVIDIA H100.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

``BENCHMARK.json`` at the root of the repository lists the
configurations, cells and metrics; ``manifest.py`` finds their files.
"""
