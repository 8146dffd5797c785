"""Hand-written Hopper kernels of the port (CUDA C++ in ``csrc/``).

Each module holds a kernel's plain PyTorch twin, its launcher and the
autograd wrapper the model calls; ``build`` compiles the sources."""
