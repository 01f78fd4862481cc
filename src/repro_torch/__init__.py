"""repro_torch: the PyTorch and CUDA port of the serving and training system.

A second package beside the JAX reference (``src/repro``), with the same
layout: ``configs``, ``core``, ``kernels`` (hand-written Hopper kernels
built from ``csrc/``), ``models``, ``serving``, ``training``, ``data``
and ``launch``.  It imports
torch and nothing of the reference.
"""
