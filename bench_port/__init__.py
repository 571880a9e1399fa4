"""The benchmark of `dsr_tpu_torch`, the PyTorch and CUDA port, on NVIDIA
GPUs.  `run.py` runs one cell of `BENCHMARK.json` once; everything that
belongs to one configuration, traffic mix or per-layer metric sits in a
file of its own, found by name (see `harness.py`)."""
