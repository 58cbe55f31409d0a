"""Benchmark of ``microstructure_fingerprinting_torch`` on NVIDIA GPUs:
``python3 -m mfbench --workload <name> --seed <n> --seconds <s> --trace
<0|1>`` (see ``run.py`` and ``README.md``)."""
