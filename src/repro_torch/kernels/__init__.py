"""Hand-written Hopper kernels of the datapath (CUDA C++ in `csrc/`), their
plain PyTorch versions (`ref.py`) and the public, device-routed API
(`ops.py`)."""
