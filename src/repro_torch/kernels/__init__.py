"""Hand-written Hopper kernels (sources in `repro_torch/csrc/`), each with
its plain PyTorch version in `ref.py` and its device dispatch in `ops.py`."""
