"""Per-device cost of an eager PyTorch step, counted as it runs: the
counterpart of the JAX package's ``repro.analysis.hlo``.

The port has no compiled program to read, so `analyze(fn, *args)` runs
``fn`` under a ``TorchDispatchMode`` (`CostMode`) that sees every aten op
on this device's tensors and counts:

  * FLOPs of matmul, bmm, einsum (which runs as bmm), conv and
    conv-transpose, by ``torch.utils.flop_counter``'s formulas, on the
    LOCAL tensors only.  A DTensor op reaches the mode twice, once at the
    DTensor level (global shapes) and once on each rank's shards; the mode
    declines the first (``NotImplemented``), so DTensor unwraps it and the
    mode counts what this rank computes.  Ops that DTensor's sharding
    propagation runs on fake tensors of its own are not counted either;
  * bytes = operands + result of every aten op that launches work (views
    and allocations launch none).  This is a no-fusion model of what eager
    PyTorch runs, one kernel an op; the reference's fused-kernel model of
    XLA's HLO is not the yardstick here, and for the same function this
    count is the larger;
  * collectives by kind with their payloads, all-reduce counted twice (the
    ring model of ``hlo.py``; reduce-scatter by its input, the others by
    their result), each also filed under the link it crosses (`link_of`);
  * ``n_ops``: the aten ops dispatched on this device's tensors (views
    included: each costs the host a dispatch), plus the hand-written
    kernels' launches, which the kernels' wrappers report
    (`record_kernel`); on an eager LM step this count, not the device,
    sets the pace;
  * ``peak_bytes``: the most bytes held at once by storages that ops of
    ``fn`` created (its inputs are not counted), from a live-storage
    tracker of this module's own: each new storage is added when an op
    returns it and taken off by a finalizer when it is freed;
    ``largest_bytes`` the largest such storage.

Loop multipliers (the counterpart of ``hlo.py``'s trip counts).  The
port's step loops are Python loops.  A loop whose iterations do the same
work at the same shapes is written ``for i in trips(n)``: under a counter
in "multiply" mode it runs three iterations, weighted 1, ``n - 2`` and 1
(`trips` says why), and `repeat` gives the loop's list of per-iteration
results its ``n`` entries.  The autograd nodes an iteration records keep
its weights, and their backward ops count with them.  Only iterations
that really run are loops here: the port's blocked attention masks and
skips no block, so every block counts.  A real run, and a counter in
"run" mode, runs every iteration.  The multiplied count equals the full
loop's for a forward step, and in FLOPs and collectives for a training
step; its op count and bytes there are close but not equal, as the
engine adds gradients into one another in the order they arrive.  Under
a multiplier ``peak_bytes`` is a lower bound: the iterations that do not
run hold no activations, though the results that `repeat` replicates
are counted ``n`` times.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from typing import Any, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..core import counting
# the multiplier and the kernels' hook live where the models and the
# kernel wrappers reach them without the analysis layer; they are this
# module's API as well
from ..core.counting import (active, is_fake, local, nbytes,  # noqa: F401
                             record_kernel, repeat, trips)

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

# the cards of one NVLink domain (an H100 SXM node)
NODE_CARDS = 8

_FUNCOL_KIND = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
    "send": "collective-permute", "recv_": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d")

# ops that launch no work: allocations and metadata (views are found by
# their schema)
_NO_WORK = {
    "empty", "empty_strided", "empty_like", "new_empty",
    "new_empty_strided", "detach", "alias", "lift_fresh",
    "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "is_same_size", "set_", "resize_",
    "wait_tensor",
}
# in-place ops that write their first operand without reading it
_WRITE_ONLY = {"copy_", "fill_", "zero_", "normal_", "uniform_", "random_",
               "bernoulli_", "exponential_", "index_put_"}


@dataclasses.dataclass
class Cost:
    """One device's cost of one call.  ``collectives`` maps a kind to
    (calls, link bytes); ``link_bytes`` the collective bytes by the link
    they cross ("nvlink" within a node, "ib" across nodes); ``kernels``
    the hand-written kernels' launches by name; ``argument_bytes`` and
    ``output_bytes`` the local bytes of the call's tensors in and out."""

    flops: float
    bytes_accessed: float
    collective_bytes: float
    collectives: Dict[str, Tuple[int, float]]
    n_ops: int
    peak_bytes: float
    link_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernels: Dict[str, int] = dataclasses.field(default_factory=dict)
    argument_bytes: float = 0.0
    output_bytes: float = 0.0
    largest_bytes: float = 0.0


def tree_bytes(tree) -> int:
    """The local bytes of every tensor in a tree, each storage once."""
    seen, total = set(), 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            t = local(t)
            key = id(t.untyped_storage())
            if key not in seen:
                seen.add(key)
                total += t.untyped_storage().nbytes()
    return total


_LINKS: Dict[Tuple[str, int], str] = {}


def link_of(group_name: str) -> str:
    """"nvlink" when every rank of the process group lies in one node of
    `NODE_CARDS` cards (ranks numbered node by node), else "ib"."""
    import torch.distributed as dist

    key = (group_name, dist.get_world_size())
    if key not in _LINKS:
        from torch.distributed.distributed_c10d import _resolve_process_group

        ranks = dist.get_process_group_ranks(
            _resolve_process_group(group_name))
        _LINKS[key] = (
            "nvlink" if len({r // NODE_CARDS for r in ranks}) == 1 else "ib")
    return _LINKS[key]


class _Frame:
    """One multiplied loop: its trip count and the call site that runs it
    (a checkpoint's recompute re-enters the same site)."""

    __slots__ = ("n", "site")

    def __init__(self, n: int, site):
        self.n, self.site = n, site


class _Tagger(torch.overrides.TorchFunctionMode):
    """Every autograd node that an op records (a composite op's inner
    nodes too: the walk goes back to the nodes recorded before the
    innermost loop's iteration began) keeps the loops it was recorded in;
    its backward, and the add of its gradient into one already there, are
    counted with them."""

    def __init__(self, counter: "CostMode"):
        super().__init__()
        self.counter = counter

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        todo = [t.grad_fn for t in tree_leaves(out)
                if isinstance(t, torch.Tensor) and t.grad_fn is not None]
        start = self.counter._starts[-1]
        while todo:
            node = todo.pop()
            if (node is None or "cost_frames" in node.metadata
                    or node._sequence_nr() < start
                    or node.name().endswith("AccumulateGrad")):
                continue
            self.counter._tag(node)
            todo.extend(n for n, _ in node.next_functions)
        return out


class CostMode(TorchDispatchMode):
    """The counter.  ``fake_mode``: the FakeTensorMode whose tensors are
    this run's (None for real tensors); fake tensors of any other mode
    (DTensor's sharding propagation) are not counted.  ``loops``:
    "multiply" or "run" (see `trips`)."""

    def __init__(self, fake_mode=None, loops: str = "multiply"):
        super().__init__()
        if loops not in ("multiply", "run"):
            raise ValueError(f"loops is 'multiply' or 'run', not {loops!r}")
        self.fake_mode, self.loops = fake_mode, loops
        self.flops = 0.0
        self.bytes = 0.0
        self.n_ops = 0
        self.coll: Dict[str, List[float]] = {}
        self.links: Dict[str, float] = {}
        self.kernels: Dict[str, int] = {}
        self.live = 0.0
        self.peak = 0.0
        self.largest = 0.0
        self._tracked: Dict[int, Any] = {}
        self._shadow: Dict[int, Any] = {}
        self._stack: List[_Frame] = []
        self._starts: List[int] = []
        self._node_frames: Tuple[_Frame, ...] = ()
        self._in_backward = False
        self._tagger = _Tagger(self)
        self.mult = 1

    # -- the multiplier -----------------------------------------------------
    def _update(self) -> None:
        frames = list(self._stack)
        sites = {f.site for f in frames}
        frames += [f for f in self._node_frames
                   if f not in frames and f.site not in sites]
        self.mult = math.prod(f.n for f in frames)

    def _region(self, n: int, site):
        from torch._C._autograd import _get_sequence_nr

        self._stack.append(None)
        self._starts.append(0)
        try:
            for i, weight in ((0, 1), (1, n - 2), (2, 1)):
                self._stack[-1] = _Frame(weight, site)
                self._starts[-1] = _get_sequence_nr()
                self._update()
                yield i
        finally:
            self._stack.pop()
            self._starts.pop()
            self._update()

    def _tag(self, node) -> None:
        """A node's backward runs with the loops it was recorded in; they
        stay in effect after it, for the engine's add of a gradient it
        sends into one already waiting, until the next node or the end of
        the backward."""
        frames = tuple(self._stack)
        node.metadata["cost_frames"] = frames

        def pre(grad_outputs):
            if not self._in_backward:
                self._in_backward = True
                torch.autograd.Variable._execution_engine.queue_callback(
                    self._end_backward)
            self._node_frames = frames
            self._update()

        node.register_prehook(pre)

    def _end_backward(self) -> None:
        self._in_backward = False
        self._node_frames = ()
        self._update()

    # -- live storages --------------------------------------------------------
    def _add(self, n: float) -> None:
        self.live += n
        self.peak = max(self.peak, self.live)

    def _sub(self, n: float) -> None:
        self.live -= n

    def _hold(self, n: float, t: torch.Tensor) -> None:
        self._add(n)
        weakref.finalize(local(t).untyped_storage(), self._sub, n)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        ref = self._tracked.get(key)
        if ref is not None and ref() is st:
            return
        n = st.nbytes()
        self._tracked[key] = weakref.ref(st)
        self.largest = max(self.largest, n)
        self._add(n)
        weakref.finalize(st, self._sub, n)

    # -- counting ------------------------------------------------------------
    def _foreign(self, func, ins, outs) -> bool:
        """An op on the "meta" device (shapes only), or an op of DTensor's
        sharding propagation, which runs each new op
        once on fake tensors of the global shapes: under real tensors they
        are another FakeTensorMode's; under this run's own mode they are
        made by ``empty_strided`` with no tensor operand (DTensor's
        ``gen_fake_args``), and so is all that follows from them."""
        from torch._subclasses.fake_tensor import FakeTensor

        if any(t.device.type == "meta" or (isinstance(t, FakeTensor) and
               t.fake_mode is not self.fake_mode) for t in ins + outs):
            return True   # shapes only, or another mode's fakes
        if self.fake_mode is None:
            return False
        if (any(self._is_shadow(t) for t in ins)
                or (not ins and func is torch.ops.aten.empty_strided.default)):
            for t in outs:
                self._shadow[id(t)] = weakref.ref(t)
            return True
        return False

    def _is_shadow(self, t) -> bool:
        ref = self._shadow.get(id(t))
        return ref is not None and ref() is t

    def _kernel(self, name: str, flops: float, bytes_: float) -> None:
        m = self.mult
        self.flops += m * flops
        self.bytes += m * bytes_
        self.n_ops += m
        self.kernels[name] = self.kernels.get(name, 0) + m

    def _collective(self, name: str, args, kwargs, out, m: int) -> None:
        kind = _FUNCOL_KIND.get(name)
        if kind is None:
            return
        if kind == "reduce-scatter":
            payload = sum(nbytes(t) for t in tree_leaves(args[:1])
                          if isinstance(t, torch.Tensor))
        else:
            payload = sum(nbytes(t) for t in tree_leaves(out)
                          if isinstance(t, torch.Tensor))
        payload *= 2.0 if kind == "all-reduce" else 1.0
        cnt = self.coll.setdefault(kind, [0, 0.0])
        cnt[0] += m
        cnt[1] += m * payload
        group = next((a for a in reversed(list(args) + list(kwargs.values()))
                      if isinstance(a, str)), None)
        link = link_of(group) if group is not None else "ib"
        self.links[link] = self.links.get(link, 0.0) + m * payload

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor

        kwargs = kwargs or {}
        if any(t is not torch.Tensor and not issubclass(t, FakeTensor)
               for t in types):
            return NotImplemented   # a DTensor: count its local ops
        out = func(*args, **kwargs)
        ns = func.namespace
        if ns == "prim":
            return out
        ins = [a for a in tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        if self._foreign(func, ins, outs):
            return out
        m = self.mult
        self.n_ops += m
        name = func._schema.name.split("::")[-1]
        if ns in _COLLECTIVE_NAMESPACES:
            self._collective(name, args, kwargs, out, m)
        if func.is_view:
            return out
        if name not in _NO_WORK:
            read = ins[1:] if name in _WRITE_ONLY else ins
            self.bytes += m * (sum(map(nbytes, read))
                               + sum(map(nbytes, outs)))
            from torch.utils.flop_counter import flop_registry

            f = flop_registry.get(func._overloadpacket)
            if f is not None:
                self.flops += m * f(*args, **kwargs, out_val=out)
        # an allocation launches nothing but holds its storage
        inputs = {id(t.untyped_storage()) for t in ins}
        for o in outs:
            if id(o.untyped_storage()) not in inputs:
                self._track(o)
        return out

    def __enter__(self):
        from torch._C._autograd import _get_sequence_nr

        counting.push(self)
        self._starts.append(_get_sequence_nr())
        self._tagger.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._tagger.__exit__(*exc)
            self._starts.pop()
            counting.pop(self)

    def result(self, argument_bytes: float = 0.0,
               output_bytes: float = 0.0) -> Cost:
        coll = {k: (int(v[0]), v[1]) for k, v in self.coll.items()}
        return Cost(flops=self.flops, bytes_accessed=self.bytes,
                    collective_bytes=sum(v[1] for v in coll.values()),
                    collectives=coll, n_ops=int(self.n_ops),
                    peak_bytes=self.peak, link_bytes=dict(self.links),
                    kernels=dict(self.kernels),
                    argument_bytes=argument_bytes, output_bytes=output_bytes,
                    largest_bytes=self.largest)


def analyze(fn, *args, fake_mode=None, loops: str = "multiply",
            **kwargs) -> Cost:
    """``fn(*args, **kwargs)`` run once under a `CostMode`: this device's
    `Cost` of the call.  With ``fake_mode`` (the FakeTensorMode that made
    the fake ``args``) the call runs inside it and allocates nothing."""
    counter = CostMode(fake_mode=fake_mode, loops=loops)
    with contextlib.ExitStack() as stack:
        if fake_mode is not None:
            stack.enter_context(fake_mode)
        stack.enter_context(counter)
        out = fn(*args, **kwargs)
    arg_bytes = tree_bytes((args, kwargs))
    in_storages = {id(local(t).untyped_storage())
                   for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)}
    fresh = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)
             and id(local(t).untyped_storage()) not in in_storages]
    return counter.result(arg_bytes, tree_bytes(fresh))


def measured_bytes(fn, *args) -> float:
    """``bytes_accessed`` of one call of ``fn(*args)``: the eager byte
    model (operands + result of every op that launches work; a kernel's
    launch reports its own operands and result)."""
    return analyze(fn, *args).bytes_accessed


# ---------------------------------------------------------------------------
# deconv HBM-traffic accounting (modeled)
# ---------------------------------------------------------------------------
def deconv_traffic_report(geom, t_oh: int, t_ow: int, t_ci: int, t_co: int,
                          dtype_bytes: int = 4) -> Dict[str, float]:
    """Modeled HBM bytes of one deconv layer (per batch element) under the
    halo-streaming kernel vs the full-image pipeline (which re-streamed
    the whole padded input per grid program): the reference's dict.

    ``in_bytes_per_tile`` is the Eq. 5 window, constant per tile and
    independent of image size; ``traffic_reduction`` the ratio."""
    from ..core.tiling import deconv_traffic, full_image_traffic

    t = deconv_traffic(geom, t_oh, t_ow, t_ci, t_co, dtype_bytes)
    full = full_image_traffic(geom, t_oh, t_ow, t_ci, t_co, dtype_bytes)
    return {
        "n_tiles": t.n_tiles,
        "n_ci_steps": t.n_ci_steps,
        "in_bytes_per_tile": t.in_bytes_per_tile,
        "w_bytes_per_tile": t.w_bytes_per_tile,
        "out_bytes_per_tile": t.out_bytes_per_tile,
        "halo_total_bytes": t.total_bytes,
        "full_image_in_bytes_per_tile": full.in_bytes_per_tile,
        "full_image_total_bytes": full.total_bytes,
        "traffic_reduction": full.total_bytes / max(t.total_bytes, 1),
    }
