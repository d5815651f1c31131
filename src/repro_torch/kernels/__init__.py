"""Kernel families of the port, one package each, as in repro.kernels:
`ref.py` (the plain PyTorch version), `kernel.py` (the CUDA kernel's
wrapper: checks, launch, launch count, and the device rule of
backend.py) and `ops.py` (the shape preparation around it)."""
