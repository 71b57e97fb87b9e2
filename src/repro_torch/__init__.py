"""PyTorch/CUDA port of the reverse-loop DCNN inference stack.

A second package beside the JAX reference ``repro``: the same plan ->
engine -> layer -> kernel structure, with the deconvolution kernel written
in CUDA C++ for Hopper (``csrc/deconv2d.cu``).  Imports torch and numpy
only.  Entry points run on the card unless the caller passes CPU tensors
or ``device="cpu"``; a missing card raises, it never falls back.
"""
