"""The zero-skip deconv kernel.  Its launch count is
``repro_torch.kernels.deconv2d_sparse.kernel.LAUNCHES``."""
from .kernel import (build_schedule, deconv2d_sparse_launch,
                     deconv2d_sparse_launch_plain, schedule_tensors)
from .ops import deconv2d_sparse, make_sparse_plan
from .ref import deconv2d_sparse_ref

__all__ = ["build_schedule", "deconv2d_sparse", "deconv2d_sparse_launch",
           "deconv2d_sparse_launch_plain", "deconv2d_sparse_ref",
           "make_sparse_plan", "schedule_tensors"]
