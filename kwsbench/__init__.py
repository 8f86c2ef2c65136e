"""The benchmark of ``honk_tpu_torch`` on NVIDIA cards (``BENCHMARK.json`` at the root names its cells).

``run.py`` runs one cell once; ``harness.py`` finds the cell's files by name; ``drivers/<kind>.py`` drive
each kind of traffic through the port; ``metrics/<name>.py`` read the per-layer metrics; ``reference/`` is
the plain reference and the yardstick, which import nothing of the port; ``calibrate.py`` reads the numbers
the limits were set from; ``tests/`` rehearse every cell on the CPU.
"""
