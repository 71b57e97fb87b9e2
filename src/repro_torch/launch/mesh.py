"""Device meshes: the single-controller data-parallel mesh of the DCNN
serving and WGAN paths, and the LM's ``torch.distributed`` mesh.

The JAX package shards a bucket's batch over a ``jax.sharding.Mesh``
with one ``shard_map`` program.  The port keeps its single controller: a
`DeviceMesh` is an ordered tuple of ``torch.device``s on a ``data`` axis
(with a ``model`` extent of 1 on the DCNN paths), and one process drives
every device of it: the serving engine captures one CUDA graph per
bucket on each device and replays them in shard order, and the trainer
runs each z shard on its device.  So ``n_devices``, the surviving prefix
of an elastic remesh and a mesh trainer's equality with ``z_shards`` are
the reference's.

The LM shards within a model (`dist.sharding`'s rule policies) over an
`LmMesh`: one process per device, a named
``torch.distributed.device_mesh.DeviceMesh`` over the whole world with
the axes ``("data", "model")``, ``"pod"`` first where there is one, and
DTensor placements on it.  On the card its process group runs NCCL and
nothing else; the CPU and gloo serve the tests, and only when asked for.

`make_production_mesh` builds the reference's production meshes, (16,
16) and (2, 16, 16), over a world of 256 or 512 ranks in ONE process: a
fake process group (``torch.testing``'s ``FakeStore`` and the "fake"
backend), whose collectives move nothing.  The dry run and the hill-climb
place fake tensors on it and count one rank's step (`analysis.cost`);
nothing runs on a device.

Defined as functions, so importing this module touches no device.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Any, Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """``devices`` in row-major ``(data, model)`` order: shard i of the
    batch lives on ``devices[i * model]``.  A device may appear more than
    once (a test mesh of several shards on one device)."""

    devices: Tuple[torch.device, ...]
    model: int = 1

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        object.__setattr__(self, "devices", devs)
        if not devs or self.model < 1 or len(devs) % self.model:
            raise ValueError(f"{len(devs)} device(s) do not form a "
                             f"(data, model={self.model}) mesh")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh holds devices of one type: {devs}")

    @property
    def data(self) -> int:
        return len(self.devices) // self.model

    @property
    def shape(self) -> Dict[str, int]:
        """``{"data": ..., "model": ...}``, as ``jax.sharding.Mesh.shape``."""
        return {"data": self.data, "model": self.model}

    @property
    def data_devices(self) -> Tuple[torch.device, ...]:
        """The device of each batch shard, in shard order."""
        return self.devices[::self.model]


def _cuda_devices() -> Tuple[torch.device, ...]:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device is visible: a serving mesh spans "
                           "the cards (make_test_mesh builds one on the CPU)")
    return tuple(torch.device("cuda", i) for i in range(n))


def make_serving_mesh(data: int = 0) -> DeviceMesh:
    """Pure data-parallel mesh for the DCNN bucket-serving / WGAN paths:
    one ``data`` axis over the first ``data`` visible CUDA devices
    (default: every one).  Params replicate; only the batch dim shards."""
    devs = _cuda_devices()
    if data:
        if data > len(devs):
            raise ValueError(f"{data} shards over {len(devs)} visible "
                             "device(s)")
        devs = devs[:data]
    return DeviceMesh(devs)


def make_test_mesh(data: int = 2, model: int = 1,
                   device="cuda") -> DeviceMesh:
    """A ``(data, model)`` mesh that repeats one ``device``: 4 shards on
    the CPU in the tests, or 2 shards on one card."""
    return DeviceMesh((torch.device(device),) * (data * model), model=model)



# ---------------------------------------------------------------------------
# the LM's mesh: one process per device, DTensor placements
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LmMesh:
    """A named ``torch.distributed`` device mesh over every rank of the
    default process group.  ``shape`` is the dict view that the rule
    functions read (as ``jax.sharding.Mesh.shape``); ``device_mesh`` is
    what DTensor places on."""

    device_mesh: Any

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.device_mesh.mesh_dim_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.device_mesh.shape))

    @property
    def holds_shards(self) -> bool:
        """Whether this rank is in the mesh (an elastic remesh leaves the
        surviving ranks past its prefix idle)."""
        return self.device_mesh.get_coordinate() is not None

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.device_mesh.get_local_rank(axis)

    def get_group(self, axis: str):
        """The process group of the ranks that differ only along ``axis``
        (its group rank is the coordinate along ``axis``)."""
        return self.device_mesh.get_group(axis)


def init_distributed(device_type: str = "cuda", store=None, rank: int = -1,
                     world_size: int = -1) -> None:
    """Join the default process group: NCCL on the card (each rank on
    ``cuda:LOCAL_RANK``), gloo only for ``device_type="cpu"``.  With no
    ``store`` the rendezvous is ``torch.distributed.run``'s environment.
    There is no fallback: a failing NCCL init raises."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed('cuda') without a visible "
                               "card")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        backend = "nccl"
    elif device_type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process group for device type {device_type!r}")
    kw = {} if store is None else {"store": store, "rank": rank,
                                   "world_size": world_size}
    dist.init_process_group(backend, timeout=datetime.timedelta(minutes=10),
                            **kw)


def make_lm_mesh(data: int = 1, model: int = 1, pod: int = 0,
                 device_type: str = "cuda") -> LmMesh:
    """The ``(pod?, data, model)`` mesh over the current world (the
    reference's ``make_test_mesh(data, model, pod)``, one rank per
    device).  The world size must be the mesh's size; a mesh on "cuda"
    needs the NCCL backend."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_lm_mesh needs a process group "
                           "(launch.mesh.init_distributed)")
    shape = (pod, data, model) if pod else (data, model)
    names = ("pod", "data", "model") if pod else ("data", "model")
    n = math.prod(shape)
    if n != dist.get_world_size():
        raise ValueError(f"a {dict(zip(names, shape))} mesh needs {n} ranks, "
                         f"the world has {dist.get_world_size()}")
    if device_type == "cuda" and dist.get_backend() != "nccl":
        raise RuntimeError(f"a mesh on the card runs NCCL, not "
                           f"{dist.get_backend()}")
    return LmMesh(init_device_mesh(device_type, shape,
                                   mesh_dim_names=names))


# ---------------------------------------------------------------------------
# the production meshes over a fake world (the dry run's)
# ---------------------------------------------------------------------------
def _fake_store():
    """``FakeStore``, whose import also registers the "fake" backend."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "this torch has no fake process group "
            "(torch.testing._internal.distributed.fake_pg): the dry run "
            "needs it to build a 256/512-rank mesh in one process") from e
    return FakeStore


_PRODUCTION: Dict[Tuple[int, ...], LmMesh] = {}


def init_fake_world(world_size: int) -> None:
    """Make the default process group a fake one of ``world_size`` ranks,
    this process rank 0.  A fake group of another size is replaced; a real
    one is refused."""
    import torch.distributed as dist

    store_cls = _fake_store()
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} process group is "
                               "running: the fake world needs a process "
                               "of its own")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
        _PRODUCTION.clear()
    dist.init_process_group("fake", store=store_cls(), rank=0,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False) -> LmMesh:
    """Single pod: (data=16, model=16) = 256 ranks; multi-pod: (pod=2,
    data=16, model=16) = 512, the pod axis pure data parallelism.  Over a
    fake world of that size (`init_fake_world`), on device type "cpu":
    the placements and collectives are the production mesh's, the tensors
    fake."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    init_fake_world(math.prod(shape))
    if shape not in _PRODUCTION:
        _PRODUCTION[shape] = LmMesh(init_device_mesh(
            "cpu", shape, mesh_dim_names=names))
    return _PRODUCTION[shape]


def destroy_fake_world() -> None:
    """Drop the fake default group (and the meshes built on it)."""
    import torch.distributed as dist

    _PRODUCTION.clear()
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()
