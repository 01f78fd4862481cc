"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Each module holds one kernel's wrapper (CUDA tensors launch the kernel
built from ``repro_torch/csrc``, CPU tensors run the plain version, any
other device raises), the plain version itself, and the wrapper's launch
count.
"""
