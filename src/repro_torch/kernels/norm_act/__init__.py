"""The instance-norm and activation kernel (``csrc/norm_act.cu``) and its
plain version; its launch count is ``kernel.LAUNCHES``."""
from .kernel import Dest, norm_act, norm_act_plain, normalize, space_to_depth

__all__ = ["Dest", "norm_act", "norm_act_plain", "normalize",
           "space_to_depth"]
