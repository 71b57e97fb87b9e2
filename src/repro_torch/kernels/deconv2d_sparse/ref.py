"""Oracle for the zero-skip kernel: the dense oracle on pruned weights
(zero-skipping must not change results, only skip work)."""
from ..deconv2d.ref import deconv2d_ref as deconv2d_sparse_ref  # noqa: F401
