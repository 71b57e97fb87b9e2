"""The reverse-loop deconv kernel.  Its launch count is
``repro_torch.kernels.deconv2d.kernel.LAUNCHES``."""
from .kernel import deconv2d_launch, deconv2d_launch_plain
from .ops import deconv2d
from .ref import deconv2d_ref

__all__ = ["deconv2d", "deconv2d_launch", "deconv2d_launch_plain",
           "deconv2d_ref"]
