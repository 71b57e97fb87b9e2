"""Whole-generator execution plan: one `DeconvPlan` per layer.

A deployment serializes the plan (`to_json`) and reloads it (`from_json`)
to serve exactly the configuration that was validated.  The document format
and its content hash are the JAX package's (``"kind": "repro.NetworkPlan"``),
so a plan pinned by the JAX reference loads here and its ``stable_hash``
verifies.  `for_hopper` then re-resolves only its tiles for the card and
maps the TPU backend name ``"pallas"`` to ``"cuda"``; geometry,
activations, batch and workload are kept.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional, Tuple

from .deconv_plan import (PLAN_SCHEMA_VERSION, DeconvPlan, PlanSchemaError,
                          build_layer_plan)

PRECISIONS = ("fp32",)
# JAX package backend -> this package's backend of the same formulation
_BACKEND_FOR = {"pallas": "cuda", "xla": "cudnn", "reverse_loop": "reverse_loop",
                "cuda": "cuda", "cudnn": "cudnn"}


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} is not served by this "
                         f"package yet; expected one of {PRECISIONS}")


@dataclasses.dataclass(frozen=True)
class NetworkPlan:
    """Per-layer `DeconvPlan`s plus the network-level choices that bind
    them: backend, precision and the batch every layer's tiles were fitted
    to."""

    name: str
    backend: str
    precision: str
    batch: int
    layers: Tuple[DeconvPlan, ...]
    workload: Optional[str] = None
    schema_version: int = PLAN_SCHEMA_VERSION

    def __post_init__(self):
        _check_precision(self.precision)

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

    def for_hopper(self) -> "NetworkPlan":
        """This plan for the H100 kernel: the backend mapped to its
        counterpart here and every tiled layer's tiles re-resolved by
        `autotune.hopper_tiles`; all other fields kept."""
        backend = _BACKEND_FOR.get(self.backend)
        if backend is None:
            raise PlanSchemaError(
                f"backend {self.backend!r} has no counterpart in this "
                "package yet")
        layers = tuple(
            build_layer_plan(l.geometry, batch=l.batch, dtype=l.dtype,
                             backend=backend, activation=l.activation)
            for l in self.layers)
        return dataclasses.replace(self, backend=backend, layers=layers)

    # -- hashing / serialization ---------------------------------------
    def stable_hash(self) -> str:
        d = {"schema": self.schema_version, "name": self.name,
             "backend": self.backend, "precision": self.precision,
             "batch": self.batch, "quant_strategy": None,
             "layers": [l.request_dict("full") for l in self.layers]}
        # keyed in only when set, as in the JAX package
        if self.workload is not None:
            d["workload"] = self.workload
        blob = json.dumps(d, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:24]

    def to_json(self) -> str:
        return json.dumps({
            "schema": self.schema_version,
            "kind": "repro.NetworkPlan",
            "name": self.name,
            "backend": self.backend,
            "precision": self.precision,
            "batch": self.batch,
            "quant_strategy": None,
            "workload": self.workload,
            "stable_hash": self.stable_hash(),
            "layers": [l.to_json_dict() for l in self.layers],
        }, indent=1, sort_keys=True)

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
        if d.get("quant_strategy") is not None:
            raise PlanSchemaError("int8 plans are not served by this "
                                  "package yet")
        try:
            _check_precision(d["precision"])
        except ValueError as e:
            raise PlanSchemaError(str(e)) from None
        plan = cls(
            name=d["name"], backend=d["backend"], precision=d["precision"],
            batch=int(d["batch"]), workload=d.get("workload"),
            layers=tuple(DeconvPlan.from_json_dict(l) for l in d["layers"]),
        )
        want = d.get("stable_hash")
        if want is not None and plan.stable_hash() != want:
            raise PlanSchemaError(
                "NetworkPlan content hash mismatch: the document was "
                "edited after it was pinned")
        return plan


def build_network_plan(
    cfg,
    *,
    batch: int = 1,
    backend: str = "cuda",
    precision: str = "fp32",
) -> NetworkPlan:
    """Plan a whole generator (``cfg`` is a `models.dcnn.DcnnConfig`) at
    the batch every layer's kernel will see (a serving bucket)."""
    from ..models.dcnn import BACKENDS
    from ..workloads import workload_name_for

    _check_precision(precision)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")

    layers = tuple(
        build_layer_plan(g, batch=batch, dtype=cfg.dtype, backend=backend,
                         activation=l.activation)
        for g, l in zip(cfg.geometries(), cfg.layers))
    return NetworkPlan(name=cfg.name, backend=backend, precision=precision,
                       batch=batch, layers=layers,
                       workload=workload_name_for(cfg))
