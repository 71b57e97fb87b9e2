"""LM training step (the JAX package's ``repro.train.lm``): the causal LM
loss plus the MoE aux loss, gradient accumulation over microbatches, and
optional int8 gradient compression with error feedback; the recompute of
each unit follows ``cfg.remat`` (`models.transformer.apply_lm`).

Gradients come from ``torch.autograd`` on detached copies of the params
that require grad, so the caller's params never carry a graph; the
update is the port's functional optimizer (`optim.AdamW`).

On logits split over the vocabulary (an `LmMesh` whose model axis shards
the vocab), the cross-entropy is vocab-parallel (`token_nll`): each rank
keeps its vocabulary shard in the forward and in the backward, and only
per-token maxima and sums cross the model axis, where ``log_softmax``
would have DTensor gather the whole vocabulary and build its gradient on
every rank.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.counting import trips
from ..core.tree import tree_leaves, tree_map, tree_unflatten
from ..dist.context import all_reduce, batch_placements, shard_of
from ..models.transformer import ModelConfig, apply_lm
from ..optim.compression import EFState, compress_grads, decompress_grads


def lm_loss(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """Masked cross-entropy in float32 over the token region (labels < 0
    masked) plus ``cfg.aux_loss_coef`` x the aux loss; returns (loss,
    {"ce", "aux"})."""
    fe = batch.get("frontend_embeds")
    logits, _, aux = apply_lm(params, cfg, batch["tokens"], fe, mode="train")
    if fe is not None:  # loss over the token region only
        logits = logits[:, fe.shape[1]:, :]
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    nll = token_nll(logits.float(), labels.clamp(min=0))
    mask = (labels >= 0).float()
    ce = torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.0)
    loss = ce + cfg.aux_loss_coef * aux
    return loss, {"ce": ce, "aux": aux}


class VocabParallelNll(torch.autograd.Function):
    """-log softmax(logits)[label] per token, on this rank's vocabulary
    shard ``logits`` (..., V / n) float32, whose first column is vocabulary
    entry ``start``; ``reduce(t, op)`` all-reduces a per-token tensor
    ("max" or "sum") over the ranks that hold the other shards.  The
    label's logit is taken on the shard that holds it (zero elsewhere)
    and summed.  The gradient, softmax minus the label's one-hot, stays on
    the shard and needs no collective."""

    @staticmethod
    def forward(ctx, logits, labels, start, reduce):
        top = reduce(logits.detach().amax(dim=-1), "max")
        shifted = logits - top[..., None]
        rows = logits.shape[-1]
        local = labels - start
        hit = (local >= 0) & (local < rows)
        idx = local.clamp(0, rows - 1)
        picked = reduce(torch.gather(shifted, -1, idx[..., None])[..., 0]
                        * hit, "sum")
        e = torch.exp(shifted)
        total = reduce(e.sum(dim=-1), "sum")
        ctx.save_for_backward(e, total, idx, hit)
        return torch.log(total) - picked

    @staticmethod
    def backward(ctx, g):
        e, total, idx, hit = ctx.saved_tensors
        grad = e / total[..., None]
        grad.scatter_add_(-1, idx[..., None], -hit.to(grad.dtype)[..., None])
        return grad * g[..., None], None, None, None


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """-log softmax(logits)[labels] per token (float32 logits, labels in
    range).  On a DTensor split over the vocabulary by one mesh axis it
    runs shard-local (`VocabParallelNll`) on each rank's batch and
    vocabulary shards, and comes back split like the batch."""
    vocab = shard_of(logits, -1)
    if vocab is None:
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(logp, -1, labels[..., None])[..., 0]
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map

    axis, group, rank = vocab
    mesh = logits.device_mesh
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    lab_pl = batch_placements(logits)
    reduce = lambda t, op: all_reduce(t, op, group)

    def nll(lg, lab):
        return VocabParallelNll.apply(lg, lab, rank * lg.shape[-1], reduce)

    run = local_map(nll, out_placements=lab_pl,
                    in_placements=(list(logits.placements), lab_pl),
                    device_mesh=mesh, redistribute_inputs=True)
    return run(logits, labels)


def _grads_of(params, cfg: ModelConfig, batch):
    """((loss, metrics), grads): the grads in the params' tree and dtypes,
    zeros for a leaf the loss does not reach (a frontend projection
    without frontend inputs), as ``jax.grad`` gives."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    with torch.enable_grad():
        loss, met = lm_loss(tree_unflatten(params, leaves), cfg, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(l) if g is None else g
             for l, g in zip(leaves, grads)]
    met = {k: v.detach() for k, v in met.items()}
    return (loss.detach(), met), tree_unflatten(params, grads)


def make_train_step(cfg: ModelConfig, optimizer, grad_accum: int = 1,
                    compress: bool = False):
    """Returns ``train_step(params, opt_state, ef_state, batch) ->
    (params, opt_state, ef_state, metrics)``.

    ``grad_accum > 1`` splits the batch as the reference does, into
    ``(B / grad_accum, grad_accum, ...)`` with microbatch ``i`` the slice
    ``[:, i]`` (contiguous batch blocks stay on their data shard in the
    reference's layout), and sums the grads in float32.  ``compress`` runs
    the grads through int8 quantization with error feedback before the
    update."""

    def train_step(params, opt_state, ef_state: Optional[EFState], batch):
        dev = tree_leaves(params)[0].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if grad_accum == 1:
            (loss, met), grads = _grads_of(params, cfg, batch)
        else:
            micro = {k: v.reshape(v.shape[0] // grad_accum, grad_accum,
                                  *v.shape[1:]) for k, v in batch.items()}
            acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params)
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            for i in trips(grad_accum):
                mb = {k: v[:, i] for k, v in micro.items()}
                (l, _), g = _grads_of(params, cfg, mb)
                acc = tree_map(lambda a, b: a + b.float(), acc, g)
                lsum = lsum + l
                del g
            grads = tree_map(lambda g: g / grad_accum, acc)
            loss = lsum / grad_accum
            met = {"ce": loss,
                   "aux": torch.zeros((), dtype=torch.float32, device=dev)}

        if compress:
            q, s, ef_state = compress_grads(grads, ef_state)
            grads = decompress_grads(q, s)

        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, ef_state, dict(met, loss=loss)

    return train_step
