"""The benchmark of ``repro_torch``, the PyTorch and CUDA port: cells,
traffic, per-layer readers and the plain reference (see ``run.py``)."""
