"""PyTorch / CUDA port of the TriMoE serving stack for NVIDIA Hopper.

Mirrors the layout of the JAX package `repro` module by module (configs,
core, obs, kernels/<family>/{ref,ops,kernel}.py, models, serving,
launch); each module names the JAX function it ports. Plain tensor code
is PyTorch, and every Pallas TPU kernel on the serving path is a CUDA
kernel under `csrc/`, built with nvcc on first use (kernels/build.py).
"""
