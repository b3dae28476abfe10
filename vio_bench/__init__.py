"""The benchmark of the PyTorch and CUDA port, ``lfvio_tpu_torch``.

``BENCHMARK.json`` at the checkout's root names the cells; one run of one
cell is ``python3 -m vio_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` on a machine with a CUDA card. Layout, each piece found by
name: ``configs/`` (deployments), ``traffic/`` (replays, read by
``traffic.py`` over ``world.py``), ``metrics/`` (one reader a metric),
``limits/`` (the check's limits a cell), ``reference/`` (the plain
reference ``check.py`` holds the program against), ``roofline.py`` and
``trace.py`` (bounds and the trace's reduction), ``cell.py`` (a run),
``readings.py`` (the readings the limits are set from), ``tests/``.
"""
