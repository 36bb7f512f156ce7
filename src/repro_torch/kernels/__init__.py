"""Hand-written CUDA kernels (``csrc/``), their plain PyTorch versions and
the public wrappers (``ops``). Nothing here compiles at import time."""
