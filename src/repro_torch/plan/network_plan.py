"""Whole-generator execution plan: one `DeconvPlan` per layer.

A deployment serializes the plan (`to_json`) and reloads it (`from_json`)
to serve exactly the configuration that was validated.  The document format
and its content hash are the JAX package's (``"kind": "repro.NetworkPlan"``),
so a plan pinned by the JAX reference (fp32, int8 or zero-skip) loads
here and its ``stable_hash`` verifies.  `for_hopper` then re-resolves its
tiles for the card and maps the TPU backend names to their counterparts
here (``"pallas"`` -> ``"cuda"``, ``"pallas_sparse"`` -> ``"cuda_sparse"``);
geometry, activations, int8 scales, batch and workload are kept, and a
zero-skip plan's schedules are rebuilt at the new tiles.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..kernels.autotune import TileChoice
from .deconv_plan import (PLAN_SCHEMA_VERSION, DeconvPlan, PlanSchemaError,
                          _sparse_digest, build_layer_plan)

PRECISIONS = ("fp32", "int8")
# JAX package backend -> this package's backend of the same formulation
_BACKEND_FOR = {"pallas": "cuda", "pallas_sparse": "cuda_sparse",
                "xla": "cudnn", "reverse_loop": "reverse_loop",
                "cuda": "cuda", "cuda_sparse": "cuda_sparse", "cudnn": "cudnn"}


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected one of "
                         f"{PRECISIONS}")


def _weights(params, i: int) -> np.ndarray:
    w = params[f"l{i}"]["w"]
    return (w.detach().float().cpu().numpy() if hasattr(w, "detach")
            else np.asarray(w))


@dataclasses.dataclass(frozen=True)
class NetworkPlan:
    """Per-layer `DeconvPlan`s plus the network-level choices that bind
    them: backend, precision, the batch every layer's tiles were fitted
    to, and for int8 the calibration strategy the layer scales came
    from."""

    name: str
    backend: str
    precision: str
    batch: int
    layers: Tuple[DeconvPlan, ...]
    quant_strategy: Optional[str] = None
    workload: Optional[str] = None
    schema_version: int = PLAN_SCHEMA_VERSION

    def __post_init__(self):
        _check_precision(self.precision)

    def tile_overrides(self) -> Optional[Dict[int, TileChoice]]:
        """Per-layer `autotune.TileChoice` map, or None when a layer has no
        resolved tiles."""
        if any(l.tiles is None for l in self.layers):
            return None
        return {i: l.tiles for i, l in enumerate(self.layers)}

    def sparse_plans(self) -> Optional[Dict[int, tuple]]:
        """Per-layer zero-skip schedules of a zero-skip plan ("cuda_sparse",
        or the JAX package's "pallas_sparse" at its own tiles)."""
        if _BACKEND_FOR.get(self.backend) != "cuda_sparse":
            return None
        if any(l.sparse_tables is None for l in self.layers):
            return None
        return {i: l.sparse_tables for i, l in enumerate(self.layers)}

    def quant_config(self):
        """The `quant.calibrate.QuantConfig` pinned in the per-layer plans
        (None for fp32 plans)."""
        if self.precision != "int8":
            return None
        from ..quant.calibrate import QuantConfig

        if any(l.quant is None for l in self.layers):
            raise ValueError("int8 plan is missing per-layer quant scales")
        return QuantConfig(name=self.name,
                           strategy=self.quant_strategy or "mean_ksigma",
                           layers=tuple(l.quant for l in self.layers))

    def validate_for(self, cfg) -> None:
        """Reject a plan built for a different network geometry."""
        geoms = list(cfg.geometries())
        if len(geoms) != len(self.layers):
            raise ValueError(
                f"plan '{self.name}' has {len(self.layers)} layers; "
                f"{cfg.name} has {len(geoms)}")
        for i, (g, l) in enumerate(zip(geoms, self.layers)):
            if g != l.geometry:
                raise ValueError(
                    f"plan layer {i} geometry {l.geometry} does not match "
                    f"{cfg.name} layer {i} geometry {g}")

    def verify_sparse_tables(self, params) -> None:
        """Raise when a pinned zero-skip plan's schedules no longer match
        the weights about to be served (e.g. the checkpoint was re-pruned
        after the plan was pinned): a stale schedule would skip now-nonzero
        slabs.  One O(weights) host pass."""
        if _BACKEND_FOR.get(self.backend) != "cuda_sparse":
            return
        from ..kernels.deconv2d_sparse import make_sparse_plan

        for i, l in enumerate(self.layers):
            if l.sparse_digest is None:
                continue
            g = l.geometry
            want = _sparse_digest(make_sparse_plan(
                _weights(params, i), g.stride, g.padding, l.tiles.t_ci,
                l.tiles.t_co))
            if want != l.sparse_digest:
                raise ValueError(
                    f"layer {i}: the pinned zero-skip schedule "
                    f"({l.sparse_digest}) does not match the schedule of the "
                    f"weights being served ({want}); the plan is stale, "
                    "re-plan against these params")

    def for_hopper(self, params=None) -> "NetworkPlan":
        """This plan for the H100 kernels: the backend mapped to its
        counterpart here and every tiled layer's tiles re-resolved for the
        kernel that runs the layer's dtype (`build_layer_plan`: a timed
        entry of the tile cache, else `autotune.hopper_tiles`); epilogues,
        int8 scales and the rest kept.

        A zero-skip plan's schedules were built at the TPU's channel tiles,
        so they are rebuilt (tables and digest) at the Hopper tiles from
        ``params``, the pruned weights, without which this raises."""
        backend = _BACKEND_FOR.get(self.backend)
        if backend is None:
            raise PlanSchemaError(
                f"backend {self.backend!r} has no counterpart in this package")
        if backend == "cuda_sparse" and params is None:
            raise ValueError(
                "a zero-skip plan needs params for for_hopper: its schedules "
                "are rebuilt at the Hopper tiles from the pruned weights")
        layers = tuple(
            build_layer_plan(
                l.geometry, batch=l.batch, dtype=l.dtype, backend=backend,
                activation=l.activation, out_scale=l.out_scale,
                out_dtype_bytes=l.out_dtype_bytes, quant=l.quant,
                weights=(_weights(params, i) if backend == "cuda_sparse"
                         else None))
            for i, l in enumerate(self.layers))
        return dataclasses.replace(self, backend=backend, layers=layers)

    # -- hashing / serialization ---------------------------------------
    def stable_hash(self) -> str:
        d = {"schema": self.schema_version, "name": self.name,
             "backend": self.backend, "precision": self.precision,
             "batch": self.batch, "quant_strategy": self.quant_strategy,
             "layers": [l.request_dict("full") for l in self.layers]}
        # keyed in only when set, as in the JAX package
        if self.workload is not None:
            d["workload"] = self.workload
        blob = json.dumps(d, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:24]

    def to_json(self, path: Optional[str] = None) -> str:
        """The plan's JSON document (written to ``path`` too when given)."""
        s = json.dumps({
            "schema": self.schema_version,
            "kind": "repro.NetworkPlan",
            "name": self.name,
            "backend": self.backend,
            "precision": self.precision,
            "batch": self.batch,
            "quant_strategy": self.quant_strategy,
            "workload": self.workload,
            "stable_hash": self.stable_hash(),
            "layers": [l.to_json_dict() for l in self.layers],
        }, indent=1, sort_keys=True)
        if path is not None:
            with open(path, "w") as f:
                f.write(s)
        return s

    @classmethod
    def from_json(cls, s: str) -> "NetworkPlan":
        try:
            d = json.loads(s)
        except ValueError as e:
            raise PlanSchemaError(f"not a NetworkPlan JSON document: {e}")
        if not isinstance(d, dict) or d.get("kind") != "repro.NetworkPlan":
            raise PlanSchemaError(
                "not a NetworkPlan JSON document (missing kind tag)")
        if d.get("schema") != PLAN_SCHEMA_VERSION:
            raise PlanSchemaError(
                f"NetworkPlan schema {d.get('schema')!r} is not the "
                f"supported v{PLAN_SCHEMA_VERSION}")
        try:
            _check_precision(d["precision"])
        except ValueError as e:
            raise PlanSchemaError(str(e)) from None
        plan = cls(
            name=d["name"], backend=d["backend"], precision=d["precision"],
            batch=int(d["batch"]), quant_strategy=d.get("quant_strategy"),
            workload=d.get("workload"),
            layers=tuple(DeconvPlan.from_json_dict(l) for l in d["layers"]),
        )
        if plan.precision == "int8" and any(l.quant is None
                                            for l in plan.layers):
            raise PlanSchemaError("int8 plan is missing per-layer quant "
                                  "scales")
        want = d.get("stable_hash")
        if want is not None and plan.stable_hash() != want:
            raise PlanSchemaError(
                "NetworkPlan content hash mismatch: the document was "
                "edited after it was pinned")
        return plan

    @classmethod
    def load(cls, path: str) -> "NetworkPlan":
        with open(path) as f:
            return cls.from_json(f.read())

    # -- roofline / traffic estimates ----------------------------------
    def traffic_report(self) -> Dict[int, Any]:
        """Per-layer modeled HBM traffic (`core.tiling.DeconvTraffic`) at
        this plan's batch and tiles; empty for untiled backends."""
        from ..core.tiling import deconv_traffic_batched

        out: Dict[int, Any] = {}
        for i, l in enumerate(self.layers):
            if l.tiles is None:
                continue
            t = l.tiles
            out[i] = deconv_traffic_batched(
                l.geometry, self.batch, t.t_n, t.t_oh, t.t_ow, t.t_ci,
                t.t_co, l.dtype_bytes, out_dtype_bytes=l.out_dtype_bytes)
        return out

    def modeled_attainable(self, device=None) -> Dict[int, Any]:
        """Per-layer roofline `core.dse.DsePoint` at this plan's tiles, on
        ``device`` (default `core.dse.H100_SXM`) at the layer's dtype peak:
        int8 at its int8 rate (`Device.peak_for`), bf16 at its bf16
        tensor-core rate where the device has one."""
        from ..core.dse import H100_SXM, tile_attainable

        device = H100_SXM if device is None else device
        out: Dict[int, Any] = {}
        for i, l in enumerate(self.layers):
            if l.tiles is None:
                continue
            t = l.tiles
            dev = device
            if l.dtype == "bfloat16" and device.bf16_peak_ops > 0.0:
                dev = dataclasses.replace(device,
                                          peak_ops=device.bf16_peak_ops)
            out[i] = tile_attainable(
                l.geometry, t.t_oh, t.t_ow, t.t_ci, t.t_co, dev,
                t_n=t.t_n, batch=self.batch, dtype_bytes=l.dtype_bytes,
                out_dtype_bytes=l.out_dtype_bytes)
        return out

    def modeled_network_ops(self, device=None) -> Optional[float]:
        """Whole-network modeled throughput (total ops / the sum of the
        per-layer roofline times), the paper's network metric; None if a
        layer is untiled."""
        pts = self.modeled_attainable(device)
        if len(pts) != len(self.layers):
            return None
        total_ops = sum(l.geometry.ops * self.batch for l in self.layers)
        total_t = sum(l.geometry.ops * self.batch / pts[i].attainable_ops
                      for i, l in enumerate(self.layers))
        return total_ops / total_t


def build_network_plan(
    cfg,
    *,
    batch: int = 1,
    backend: str = "cuda",
    precision: str = "fp32",
    params=None,
    quant_cfg=None,
    calib_batch: int = 64,
    calib_seed: int = 0,
    calib_strategy: str = "mean_ksigma",
    sparse_table_cache: Optional[Dict] = None,
    autotune: bool = True,
    refine: bool = False,
) -> NetworkPlan:
    """Plan a whole generator (``cfg`` is a `models.dcnn.DcnnConfig`) at
    the batch every layer's kernel will see (a serving bucket).  Each
    layer's tiles follow ``autotune`` and ``refine`` (`build_layer_plan`).

    For precision "int8" (backend "cuda" only) a ``quant_cfg`` pins
    calibrated scales; without one, ``params`` are calibrated here on
    `workloads.calibration_input`.  For backend "cuda_sparse", ``params``
    supply the pruned weights the zero-skip schedules are built from."""
    from ..models.dcnn import BACKENDS
    from ..workloads import workload_name_for

    _check_precision(precision)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if precision == "int8" and backend != "cuda":
        raise ValueError("precision='int8' runs the dense int8 kernel; "
                         f"backend={backend!r} has no quantized variant")
    if backend == "cuda_sparse" and params is None:
        raise ValueError("backend='cuda_sparse' planning needs params: the "
                         "zero-skip schedule is built from the static pruned "
                         "weights")
    int8 = precision == "int8"
    if int8 and quant_cfg is None:
        if params is None:
            raise ValueError("int8 planning needs either a quant_cfg or "
                             "params to calibrate")
        from ..quant.calibrate import calibrate
        from ..workloads import calibration_input

        device = params["l0"]["w"].device
        quant_cfg = calibrate(params, cfg, calibration_input(
            cfg, seed=calib_seed, batch=calib_batch).to(device),
            strategy=calib_strategy)
    geoms = cfg.geometries()
    layers = tuple(
        build_layer_plan(
            g, batch=batch, dtype="int8" if int8 else cfg.dtype,
            backend=backend, activation=l.activation,
            out_scale=quant_cfg.out_scale(i) if int8 else None,
            # the int8 chain's last epilogue emits f32 images
            out_dtype_bytes=4 if int8 and i == len(geoms) - 1 else None,
            quant=quant_cfg.layers[i] if int8 else None,
            weights=(_weights(params, i) if backend == "cuda_sparse"
                     else None),
            sparse_table_cache=sparse_table_cache, sparse_cache_key=i,
            autotune=autotune, refine=refine)
        for i, (g, l) in enumerate(zip(geoms, cfg.layers)))
    return NetworkPlan(name=cfg.name, backend=backend, precision=precision,
                       batch=batch, layers=layers,
                       quant_strategy=quant_cfg.strategy if int8 else None,
                       workload=workload_name_for(cfg))


def executable_fingerprints(plans) -> Dict[int, str]:
    """{per-device batch -> stable hash} over a collection of
    `NetworkPlan`s: the "same executable everywhere" check (a trainer's
    ``plan_fingerprints`` against a serving engine's plans).  Two plans
    for the same batch must agree on the hash; raises when they do not.
    The JAX package's function, copied."""
    out: Dict[int, str] = {}
    for p in plans:
        h = p.stable_hash()
        prev = out.setdefault(p.batch, h)
        if prev != h:
            raise ValueError(
                f"two plans for per-device batch {p.batch} disagree: "
                f"{prev} vs {h}")
    return out


def variant_fingerprints(plans) -> Dict[str, str]:
    """{"b{batch}/{precision}" -> stable hash} over plans that span
    precision variants (the async frontend pins one plan per bucket x
    precision).  Two plans for the same (batch, precision) must agree on
    the hash; a deployment compares these dicts across hosts to show the
    same executables everywhere.  The JAX package's function, copied."""
    out: Dict[str, str] = {}
    for p in plans:
        key = f"b{p.batch}/{p.precision}"
        h = p.stable_hash()
        prev = out.setdefault(key, h)
        if prev != h:
            raise ValueError(
                f"two plans for {key} disagree: {prev} vs {h}")
    return out
