"""The benchmark of ``points_matching_tpu_torch`` on NVIDIA GPUs.

``python3 gpu_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.  What
belongs to one configuration, traffic mix, cell or per-layer metric lives
in a file of its own (``configs/``, ``traffic/``, ``workloads/``,
``metrics/``), found by the name ``BENCHMARK.json`` gives it.
"""
