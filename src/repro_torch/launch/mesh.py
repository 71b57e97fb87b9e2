"""Data-parallel device meshes for the DCNN serving and WGAN paths.

The JAX package shards a bucket's batch over a ``jax.sharding.Mesh``
with one ``shard_map`` program.  The port keeps its single controller: a
`DeviceMesh` is an ordered tuple of ``torch.device``s on a ``data`` axis
(with a ``model`` extent of 1 on the DCNN paths), and one process drives
every device of it: the serving engine captures one CUDA graph per
bucket on each device and replays them in shard order, and the trainer
runs each z shard on its device.  So ``n_devices``, the surviving prefix
of an elastic remesh and a mesh trainer's equality with ``z_shards`` are
the reference's.  (``torch.distributed`` process groups are for the
sharded LM policies, which have not been ported.)

Defined as functions, so importing this module touches no device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

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

