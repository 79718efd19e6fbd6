"""The benchmark of ``pynndescent_torch`` on NVIDIA GPUs.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json``. Everything that belongs to one
configuration, traffic mix, kind of traffic (``loops/``), metric of distance
(``reference/``), generator or per-layer metric is a file of its own under
this folder, found by the name ``BENCHMARK.json`` or a configuration gives
it (``spec.py``). Nothing here imports JAX or ``pynndescent_tpu``, and the
plain reference (``reference/``) imports nothing of ``pynndescent_torch``.
"""
