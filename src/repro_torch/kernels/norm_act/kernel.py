"""Launcher and plain version of the instance-norm and activation kernel
(``csrc/norm_act.cu``).

`norm_act` takes one NHWC map (any strides with the channels contiguous:
B1's padded output seen through a crop) and writes it, per image and
channel normalised over its own H x W (``gamma`` given: ``(x - mean) /
sqrt(var + eps) * gamma + beta``, var biased) or as it is (``gamma`` None,
the no-statistics mode), through a LeakyReLU of each destination's slope,
into one or two `Dest` buffers: a plain destination at a halo offset and a
channel offset (one half of a skip concatenation), or a space-to-depth
destination (the map zero-padded by 1 and cut 2 x 2 into channels, the
input of a 2 x 2 stride-1 conv).  Places of a destination that no pixel
reaches are left as they are: the caller keeps them zero.

* On a CUDA tensor it launches the kernel on the current stream (the
  library built at first use by `kernels._build`), or raises.
* On a CPU tensor it runs ``norm_act_plain``, the same function in plain
  torch (two passes over each whole map; the kernel's blocks each take two
  passes over their share of it and merge the shares with Chan's
  formula).

``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ...core.counting import is_fake

MAX_DESTS = 2
THREADS = 256     # a block (csrc kThreads)
GROUP = 8         # channels a block owns (csrc kGroup)

LAUNCHES = 0


@dataclasses.dataclass(frozen=True)
class Dest:
    """Where `norm_act` writes: ``t`` (N', H', W', C') float32, contiguous;
    ``pad`` rows and columns before the map; channels from ``off``;
    LeakyReLU at ``slope`` (0: ReLU, 1: the value itself); ``s2d``: the
    map zero-padded by 1 and cut 2 x 2 into channels, ``(p * 2 + q) * C +
    c`` for the pixel at ``(2a + p - 1, 2b + q - 1)``."""

    t: torch.Tensor
    pad: int = 0
    off: int = 0
    slope: float = 0.0
    s2d: bool = False

    def extent(self, h: int, w: int, c: int):
        """The ``(rows, columns, channels)`` the map reaches in ``t``."""
        if self.s2d:
            return (self.pad + h // 2 + 1, self.pad + w // 2 + 1,
                    self.off + 4 * c)
        return self.pad + h, self.pad + w, self.off + c


def normalize(x: torch.Tensor, gamma: Optional[torch.Tensor],
              beta: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    """The map the destinations see: each image's channel normalised over
    its H x W (two passes, the variance biased) with the affine, ``(x -
    mean) * (gamma * rstd) + beta`` as the kernel rounds it; or ``x``
    itself when ``gamma`` is None."""
    x = x.float()
    if gamma is None:
        return x
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = (x - mean).square().mean(dim=(1, 2), keepdim=True)
    return (x - mean) * (gamma.float() * torch.rsqrt(var + eps)) + beta.float()


def space_to_depth(v: torch.Tensor) -> torch.Tensor:
    """``v`` (N, H, W, C) zero-padded by 1, cut 2 x 2 into channels: (N,
    H/2 + 1, W/2 + 1, 4C), channel ``(p * 2 + q) * C + c`` of pixel
    ``(a, b)`` holding ``v[2a + p - 1, 2b + q - 1, c]``."""
    n, h, w, c = v.shape
    vp = F.pad(v, (0, 0, 1, 1, 1, 1))
    vp = vp.reshape(n, h // 2 + 1, 2, w // 2 + 1, 2, c)
    return vp.permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2 + 1, w // 2 + 1,
                                                 4 * c)


def _check(src: torch.Tensor, dests: Sequence[Dest], gamma, beta) -> None:
    if src.ndim != 4 or src.dtype != torch.float32:
        raise ValueError(f"norm_act takes a float32 NHWC map, got "
                         f"{tuple(src.shape)} {src.dtype}")
    n, h, w, c = src.shape
    if src.stride(3) != 1:
        raise ValueError("norm_act: the map's channels must be contiguous")
    if not 1 <= len(dests) <= MAX_DESTS:
        raise ValueError(f"norm_act writes 1 to {MAX_DESTS} destinations, "
                         f"got {len(dests)}")
    if (gamma is None) != (beta is None):
        raise ValueError("norm_act: gamma and beta go together")
    for v in (gamma, beta):
        if v is not None and (v.shape != (c,) or v.dtype != torch.float32
                              or v.device != src.device):
            raise ValueError(f"norm_act: gamma and beta are ({c},) float32 on "
                             f"{src.device}")
    for d in dests:
        if d.t.dtype != torch.float32 or d.t.device != src.device \
                or not d.t.is_contiguous() or d.t.ndim != 4:
            raise ValueError("norm_act: a destination is a contiguous float32 "
                             f"NHWC tensor on {src.device}")
        if d.s2d and (h % 2 or w % 2):
            raise ValueError(f"norm_act: space-to-depth of an odd map {h}x{w}")
        rows, cols, chans = d.extent(h, w, c)
        if (d.t.shape[0] < n or d.t.shape[1] < rows or d.t.shape[2] < cols
                or d.t.shape[3] < chans or min(d.pad, d.off) < 0):
            raise ValueError(f"norm_act: a {n}x{h}x{w}x{c} map "
                             f"(pad {d.pad}, off {d.off}, s2d {d.s2d}) does "
                             f"not fit {tuple(d.t.shape)}")


def norm_act_plain(src: torch.Tensor, dests: Sequence[Dest],
                   gamma: Optional[torch.Tensor] = None,
                   beta: Optional[torch.Tensor] = None,
                   eps: float = 1e-5) -> None:
    """`norm_act` in plain torch."""
    _check(src, dests, gamma, beta)
    n, h, w, c = src.shape
    v = normalize(src, gamma, beta, eps)
    for d in dests:
        a = torch.where(v > 0, v, v * d.slope)
        if d.s2d:
            # quarter (p, q) holds the pixels (2a + p - 1, 2b + q - 1):
            # rows 1 - p, 3 - p, .. at a = 1 - p, 2 - p, ..
            for p in range(2):
                for q in range(2):
                    at = d.off + (p * 2 + q) * c
                    d.t[:n, d.pad + 1 - p:d.pad + 1 - p + h // 2,
                        d.pad + 1 - q:d.pad + 1 - q + w // 2,
                        at:at + c] = a[:, 1 - p::2, 1 - q::2]
        else:
            d.t[:n, d.pad:d.pad + h, d.pad:d.pad + w, d.off:d.off + c] = a


def norm_act(src: torch.Tensor, dests: Sequence[Dest],
             gamma: Optional[torch.Tensor] = None,
             beta: Optional[torch.Tensor] = None,
             eps: float = 1e-5) -> None:
    """Normalise (``gamma`` given) and activate ``src`` into ``dests``: the
    kernel on a CUDA tensor, the plain version on a CPU one, nothing on a
    FakeTensor (a cost count)."""
    if is_fake(src):
        return
    if src.device.type == "cpu":
        norm_act_plain(src, dests, gamma, beta, eps)
        return
    _launch_cuda(src, dests, gamma, beta, eps)


def launch_params(src: torch.Tensor, dests: Sequence[Dest],
                  stats: bool) -> np.ndarray:
    """The int64 parameter words of one launch, in step with `enum Param`
    in csrc/norm_act.cu: the map's extents, its strides and the stats
    flag, then per destination its strides, pad, channel offset and
    space-to-depth flag (zeros for an absent one)."""
    n, h, w, c = src.shape
    words = [n, h, w, c, src.stride(0), src.stride(1), src.stride(2),
             int(stats)]
    for j in range(MAX_DESTS):
        if j < len(dests):
            d = dests[j]
            words += [d.t.stride(0), d.t.stride(1), d.t.stride(2), d.pad,
                      d.off, int(d.s2d)]
        else:
            words += [0] * 6
    return np.asarray(words, dtype=np.int64)


def _launch_cuda(src, dests, gamma, beta, eps) -> None:
    global LAUNCHES
    _check(src, dests, gamma, beta)
    params = launch_params(src, dests, gamma is not None)
    slopes = [d.slope for d in dests] + [0.0] * (MAX_DESTS - len(dests))
    floats = np.asarray([eps] + slopes, dtype=np.float32)
    ptrs = [d.t.data_ptr() for d in dests] + [None] * (MAX_DESTS - len(dests))
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = library().norm_act_forward(
            src.data_ptr(), None if gamma is None else gamma.data_ptr(),
            None if beta is None else beta.data_ptr(), *ptrs,
            params.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            floats.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), stream)
    if rc < 0:
        raise ValueError("norm_act kernel refused its arguments")
    if rc != 0:
        raise RuntimeError(f"norm_act kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1


_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """The library of ``csrc/norm_act.cu``, built at first use; its block
    and channel group are checked against `THREADS` and `GROUP`."""
    global _lib
    if _lib is None:
        from .._build import load

        lib = load("norm_act")
        lib.norm_act_limits.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.norm_act_limits.restype = None
        got = (ctypes.c_int * 2)()
        lib.norm_act_limits(got)
        if tuple(got) != (THREADS, GROUP):
            raise RuntimeError(f"norm_act kernel: its block {tuple(got)} is "
                               f"not the launcher's {(THREADS, GROUP)}")
        ptr = ctypes.c_void_p
        lib.norm_act_forward.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_float), ptr]
        lib.norm_act_forward.restype = ctypes.c_int
        _lib = lib
    return _lib
