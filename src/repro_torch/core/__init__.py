"""Geometry and plain reference formulations of the reverse-loop deconv."""
from .deconv import (deconv2d_algorithm1_numpy, deconv2d_reverse_loop,
                     deconv2d_zero_insertion)
from .offsets import PhasePlan, make_phase_plan
from .tiling import DeconvGeometry, HaloTile, halo_tile, kernel_smem_bytes, out_size

__all__ = [
    "DeconvGeometry", "HaloTile", "PhasePlan", "deconv2d_algorithm1_numpy",
    "deconv2d_reverse_loop", "deconv2d_zero_insertion", "halo_tile",
    "kernel_smem_bytes", "make_phase_plan", "out_size",
]
