"""Geometry, plain reference formulations of the reverse-loop deconv, and
the paper's models (DSE, traffic, Eq. 6)."""
from .deconv import (deconv2d_algorithm1_numpy, deconv2d_reverse_loop,
                     deconv2d_zero_insertion)
from .dse import (H100_SXM, PYNQ_Z2, TPU_V5E, Device, layer_dse,
                  optimize_unified_tile, per_layer_optimum, tile_attainable)
from .metric import optimal_sparsity, quality_speed_metric
from .offsets import PhasePlan, make_phase_plan
from .tiling import (DeconvGeometry, DeconvTraffic, HaloTile, deconv_traffic,
                     deconv_traffic_batched, exact_input_extent,
                     full_image_traffic, halo_tile, input_tile_extent,
                     kernel_smem_bytes, kernel_vmem_bytes, legal_tile_factors,
                     out_size)

__all__ = [
    "DeconvGeometry", "DeconvTraffic", "Device", "H100_SXM", "HaloTile",
    "PYNQ_Z2", "PhasePlan", "TPU_V5E", "deconv2d_algorithm1_numpy",
    "deconv2d_reverse_loop", "deconv2d_zero_insertion", "deconv_traffic",
    "deconv_traffic_batched", "exact_input_extent", "full_image_traffic",
    "halo_tile", "input_tile_extent", "kernel_smem_bytes",
    "kernel_vmem_bytes", "layer_dse", "legal_tile_factors", "make_phase_plan",
    "optimal_sparsity", "optimize_unified_tile", "out_size",
    "per_layer_optimum", "quality_speed_metric", "tile_attainable",
]
