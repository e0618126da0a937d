"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on an NVIDIA H100.

One command runs one cell once::

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or metric sits in
a file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``traffic/<mix>.json`` (read by the generator of
its ``kind``, ``traffic/<kind>.py``), ``workloads/<cell>.json`` and
``metrics/<metric>.py``.  The plain references (``reference/<app>.py``), the
work counts (``work.py``) and the table of peaks (``peaks.json``) are the
yardstick; they import nothing of the port.  The harness imports neither
JAX nor the JAX package.
"""
