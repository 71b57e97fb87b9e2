"""Frozen per-layer execution plan for the deconv kernel.

`DeconvPlan` pins one deconv layer's geometry, the batch its tiles are
fitted to, the dtype, the backend, the fused epilogue and the resolved
tiles: everything the kernel wrapper needs to dispatch without re-deciding
anything per call.

This slice carries the fp32 fields.  `request_dict` and `stable_hash` are
byte-for-byte those of ``repro.plan.DeconvPlan``: the int8/sparse keys
(``out_scale``, ``quant``, ``sparse_digest``) are written as null, so a port
plan and a JAX plan with the same fields hash the same, and a JAX-pinned
plan document verifies here.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, Optional

import numpy as np

from ..core.tiling import DeconvGeometry
from ..kernels.autotune import TileChoice, hopper_tiles

# Bump when the serialized plan layout changes incompatibly (the same
# version as the JAX package's, whose documents this package loads).
PLAN_SCHEMA_VERSION = 1

TILED_BACKENDS = ("cuda",)


class PlanSchemaError(ValueError):
    """A serialized plan carries a schema this code cannot execute."""


@dataclasses.dataclass(frozen=True)
class DeconvPlan:
    """One layer's pinned execution configuration.

    Planning inputs: ``geometry``, ``batch`` (the batch the tiles are
    fitted to: a serving bucket), ``dtype`` ("float32"), ``backend``
    ("cuda" is tiled; "reverse_loop"/"cudnn" leave ``tiles`` None),
    ``activation`` and ``out_dtype_bytes`` (the fused epilogue).  Resolved
    state: ``tiles``, the `TileChoice` the kernel grid runs at.
    """

    geometry: DeconvGeometry
    batch: int = 1
    dtype: str = "float32"
    backend: str = "cuda"
    activation: Optional[str] = None
    out_dtype_bytes: Optional[int] = None
    tiles: Optional[TileChoice] = None

    # -- hashing --------------------------------------------------------
    def request_dict(self, scope: str = "full") -> Dict[str, Any]:
        """Canonical planning-input dict (the JAX package's layout)."""
        d: Dict[str, Any] = {
            "schema": PLAN_SCHEMA_VERSION,
            "geometry": dataclasses.asdict(self.geometry),
            "batch": self.batch,
            "dtype": self.dtype,
            "backend": self.backend,
            "out_dtype_bytes": self.out_dtype_bytes,
        }
        if scope == "tiles":
            return d
        d.update({
            "activation": self.activation,
            "out_scale": None,
            "quant": None,
            "sparse_digest": None,
            "tiles": (self.tiles.as_kwargs()
                      if self.tiles is not None else None),
        })
        return d

    def stable_hash(self, scope: str = "full") -> str:
        """Deterministic content digest of the plan (``scope="tiles"``
        hashes only the tile-planning inputs)."""
        blob = json.dumps(self.request_dict(scope), sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:24]

    # -- (de)serialization ---------------------------------------------
    def to_json_dict(self) -> Dict[str, Any]:
        d = self.request_dict("full")
        if self.tiles is not None:
            d["tiles"] = dataclasses.asdict(self.tiles)
        return d

    @classmethod
    def from_json_dict(cls, d: Dict[str, Any]) -> "DeconvPlan":
        if d.get("schema") != PLAN_SCHEMA_VERSION:
            raise PlanSchemaError(
                f"DeconvPlan schema {d.get('schema')!r} is not the "
                f"supported v{PLAN_SCHEMA_VERSION}")
        for key in ("out_scale", "quant", "sparse_digest", "sparse_tables"):
            if d.get(key) is not None:
                raise PlanSchemaError(
                    f"plan field {key!r} belongs to the int8/zero-skip "
                    "paths, which this package does not run yet")
        tiles = d.get("tiles")
        return cls(
            geometry=DeconvGeometry(**d["geometry"]),
            batch=int(d["batch"]),
            dtype=str(d["dtype"]),
            backend=str(d["backend"]),
            activation=d.get("activation"),
            out_dtype_bytes=d.get("out_dtype_bytes"),
            tiles=(TileChoice(**{k: v for k, v in tiles.items()
                                 if k in TileChoice.__dataclass_fields__})
                   if tiles is not None else None),
        )


def build_layer_plan(
    geom: DeconvGeometry,
    *,
    batch: int = 1,
    dtype="float32",
    backend: str = "cuda",
    activation: Optional[str] = None,
) -> DeconvPlan:
    """Resolve one layer's `DeconvPlan`; tiles come from the Hopper
    heuristic.  Non-tiled backends ("reverse_loop", "cudnn") get
    ``tiles=None``."""
    dtype_name = np.dtype(dtype).name
    if backend not in TILED_BACKENDS:
        return DeconvPlan(geometry=geom, batch=batch, dtype=dtype_name,
                          backend=backend, activation=activation)
    return DeconvPlan(geometry=geom, batch=batch, dtype=dtype_name,
                      backend=backend, activation=activation,
                      tiles=hopper_tiles(geom, batch=batch))
