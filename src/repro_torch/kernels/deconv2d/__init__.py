"""The reverse-loop deconv kernels: fp32/bf16 (``kernel``) and int8
(``int8``).  Their launch counts are ``kernel.LAUNCHES`` and
``int8.LAUNCHES``."""
from .int8 import (deconv2d_int8, deconv2d_int8_launch,
                   deconv2d_int8_launch_plain)
from .kernel import deconv2d_launch, deconv2d_launch_plain
from .ops import deconv2d
from .ref import deconv2d_int8_ref, deconv2d_ref

__all__ = ["deconv2d", "deconv2d_int8", "deconv2d_int8_launch",
           "deconv2d_int8_launch_plain", "deconv2d_int8_ref",
           "deconv2d_launch", "deconv2d_launch_plain", "deconv2d_ref"]
