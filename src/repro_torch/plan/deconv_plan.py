"""Frozen per-layer execution plan for the deconv kernel.

`DeconvPlan` pins one deconv layer's geometry, the batch its tiles are
fitted to, the dtype, the backend, the fused epilogue and the resolved
tiles: everything the kernel wrapper needs to dispatch without re-deciding
anything per call.

`request_dict`, `stable_hash` and `_sparse_digest` are byte-for-byte
those of ``repro.plan``, int8 scales and zero-skip digest included, so a
port plan and a JAX plan with the same fields hash the same, and a
JAX-pinned plan document verifies here.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..core.tiling import DeconvGeometry, dtype_bytes, dtype_name
from ..kernels.autotune import TileChoice, choose_tiles, hopper_tiles

# Bump when the serialized plan layout changes incompatibly (the same
# version as the JAX package's, whose documents this package loads).
PLAN_SCHEMA_VERSION = 1

TILED_BACKENDS = ("cuda", "cuda_sparse")


class PlanSchemaError(ValueError):
    """A serialized plan carries a schema this code cannot execute."""


def _sparse_digest(tables: Tuple[np.ndarray, np.ndarray, np.ndarray]) -> str:
    """Content hash of a zero-skip schedule (make_sparse_plan output)."""
    h = hashlib.sha256()
    for a in tables:
        a = np.ascontiguousarray(a)
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class DeconvPlan:
    """One layer's pinned execution configuration.

    Planning inputs: ``geometry``, ``batch`` (the batch the tiles are
    fitted to: a serving bucket), ``dtype`` ("float32", "bfloat16" or
    "int8", the JAX package's names),
    ``backend`` ("cuda"/"cuda_sparse" are tiled; "reverse_loop"/"cudnn"
    leave ``tiles`` None), the fused epilogue (``activation``; for int8
    ``out_scale``, the requant scale of the next layer's input, and
    ``out_dtype_bytes``, 4 where the last int8 layer emits f32), ``quant``
    (the layer's calibrated `quant.calibrate.LayerQuant`) and
    ``sparse_digest`` (content hash of the zero-skip schedule).  Resolved
    state: ``tiles``, the `TileChoice` the kernel grid runs at, and
    ``sparse_tables``, the host-built ``(ci_idx, valid, tap_mask)``
    schedule (left out of equality and hash; its digest stands in).
    """

    geometry: DeconvGeometry
    batch: int = 1
    dtype: str = "float32"
    backend: str = "cuda"
    activation: Optional[str] = None
    out_scale: Optional[float] = None
    out_dtype_bytes: Optional[int] = None
    quant: Optional[Any] = None            # quant.calibrate.LayerQuant
    sparse_digest: Optional[str] = None
    tiles: Optional[TileChoice] = None
    sparse_tables: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = \
        dataclasses.field(default=None, compare=False, repr=False)

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
            "out_scale": self.out_scale,
            "quant": (dataclasses.asdict(self.quant)
                      if self.quant is not None else None),
            "sparse_digest": self.sparse_digest,
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

    # -- convenience ----------------------------------------------------
    @property
    def dtype_bytes(self) -> int:
        return dtype_bytes(self.dtype)

    def tile_kwargs(self) -> Dict[str, int]:
        if self.tiles is None:
            raise ValueError("plan has no resolved tiles "
                             f"(backend={self.backend!r})")
        return self.tiles.as_kwargs()

    def padded_geometry(self) -> Tuple[int, ...]:
        """`kernels.deconv2d.ops.halo_pad_geometry` at this plan's batch
        and tiles: ``(oh, ow, ohp, owp, pad_l, pad_rh, pad_rw, cip, cop,
        t_n, np_)``, the padded extents a launch of the layer has (the
        launcher computes the same numbers from the same inputs)."""
        from ..core.offsets import make_phase_plan
        from ..kernels.deconv2d.ops import halo_pad_geometry

        g, t = self.geometry, self.tiles
        if t is None:
            raise ValueError("plan has no resolved tiles "
                             f"(backend={self.backend!r})")
        pp = make_phase_plan(g.kernel, g.stride, g.padding)
        return halo_pad_geometry(self.batch, g.in_h, g.in_w, g.c_in,
                                 g.c_out, pp, t.t_oh, t.t_ow, t.t_ci,
                                 t.t_co, t.t_n)

    # -- (de)serialization ---------------------------------------------
    def to_json_dict(self) -> Dict[str, Any]:
        d = self.request_dict("full")
        if self.sparse_tables is not None:
            d["sparse_tables"] = [np.asarray(a).tolist()
                                  for a in self.sparse_tables]
        if self.tiles is not None:
            d["tiles"] = dataclasses.asdict(self.tiles)
        return d

    @classmethod
    def from_json_dict(cls, d: Dict[str, Any]) -> "DeconvPlan":
        if d.get("schema") != PLAN_SCHEMA_VERSION:
            raise PlanSchemaError(
                f"DeconvPlan schema {d.get('schema')!r} is not the "
                f"supported v{PLAN_SCHEMA_VERSION}")
        from ..quant.calibrate import LayerQuant

        quant = d.get("quant")
        tiles = d.get("tiles")
        tables = d.get("sparse_tables")
        if tables is not None:
            tables = tuple(np.asarray(a, np.int32) for a in tables)
        plan = cls(
            geometry=DeconvGeometry(**d["geometry"]),
            batch=int(d["batch"]),
            dtype=str(d["dtype"]),
            backend=str(d["backend"]),
            activation=d.get("activation"),
            out_scale=d.get("out_scale"),
            out_dtype_bytes=d.get("out_dtype_bytes"),
            quant=(LayerQuant(x_scale=float(quant["x_scale"]),
                              w_scale=tuple(float(v)
                                            for v in quant["w_scale"]))
                   if quant is not None else None),
            sparse_digest=d.get("sparse_digest"),
            tiles=(TileChoice(**{k: v for k, v in tiles.items()
                                 if k in TileChoice.__dataclass_fields__})
                   if tiles is not None else None),
            sparse_tables=tables,
        )
        if tables is not None and plan.sparse_digest is not None:
            got = _sparse_digest(tables)
            if got != plan.sparse_digest:
                raise PlanSchemaError(
                    f"sparse schedule content hash mismatch ({got} != "
                    f"{plan.sparse_digest}): the serialized zero-skip tables "
                    "do not match the plan that was pinned")
        return plan


def build_layer_plan(
    geom: DeconvGeometry,
    *,
    batch: int = 1,
    dtype="float32",
    backend: str = "cuda",
    activation: Optional[str] = None,
    out_scale: Optional[float] = None,
    out_dtype_bytes: Optional[int] = None,
    quant=None,
    weights=None,
    sparse_table_cache: Optional[Dict] = None,
    sparse_cache_key=None,
    autotune: bool = True,
    refine: bool = False,
) -> DeconvPlan:
    """Resolve one layer's `DeconvPlan`.  Tiles come from
    `autotune.choose_tiles` (a timed entry of the tile cache, else the
    model of the kernel that runs ``dtype``; ``refine=True`` times
    candidates on the card), or with ``autotune=False`` from the model
    alone (`autotune.hopper_tiles`; the cache is not read).  Non-tiled
    backends ("reverse_loop", "cudnn") get ``tiles=None``.

    ``weights`` (the pruned static weights) build the zero-skip schedule
    for backend "cuda_sparse"; ``sparse_table_cache`` memoises the tables
    across plans that share (``sparse_cache_key``, t_ci, t_co), e.g. a
    serving engine's buckets, which key by layer index.  The memo is used
    only when the caller names a ``sparse_cache_key``."""
    name = dtype_name(dtype)
    if backend not in TILED_BACKENDS:
        return DeconvPlan(geometry=geom, batch=batch, dtype=name,
                          backend=backend, activation=activation)
    if autotune:
        tiles = choose_tiles(geom, name, backend, refine=refine,
                             batch=batch, out_dtype_bytes=out_dtype_bytes)
    else:
        tiles = hopper_tiles(geom, batch=batch, dtype=name,
                             sparse=backend == "cuda_sparse")
    sparse_tables = digest = None
    if backend == "cuda_sparse" and weights is not None:
        from ..kernels.deconv2d_sparse import make_sparse_plan

        memo_key = (sparse_cache_key, tiles.t_ci, tiles.t_co)
        use_memo = (sparse_table_cache is not None
                    and sparse_cache_key is not None)
        if use_memo and memo_key in sparse_table_cache:
            sparse_tables = sparse_table_cache[memo_key]
        else:
            sparse_tables = make_sparse_plan(weights, geom.stride,
                                             geom.padding, tiles.t_ci,
                                             tiles.t_co)
            if use_memo:
                sparse_table_cache[memo_key] = sparse_tables
        digest = _sparse_digest(sparse_tables)
    return DeconvPlan(
        geometry=geom, batch=batch, dtype=name, backend=backend,
        activation=activation, out_scale=out_scale,
        out_dtype_bytes=out_dtype_bytes, quant=quant, sparse_digest=digest,
        tiles=tiles, sparse_tables=sparse_tables)
