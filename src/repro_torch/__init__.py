"""PyTorch/CUDA port of the reverse-loop DCNN inference stack.

A second package beside the JAX reference ``repro``: the same plan ->
engine -> layer -> kernel structure, with the deconvolution kernels written
in CUDA C++ for Hopper's tensor cores (``csrc/deconv2d_tc.cu``).  Imports torch and numpy
only.  Entry points run on the card unless the caller passes CPU tensors
or ``device="cpu"``; a missing card raises, it never falls back.
"""
