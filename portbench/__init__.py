"""The benchmark of ``digipathai_tpu_torch``, the PyTorch and CUDA port.

``run.py`` is the entry; ``BENCHMARK.json`` at the repository root names
the configurations, cells and metrics, and this package finds each one's
file by its name (``configs/``, ``traffic/``, ``metrics/``).
"""
