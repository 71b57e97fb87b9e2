"""Fault-tolerant checkpointing: npz files, atomic renames, async
background saves, a retention policy and partial-checkpoint detection on
restore (the JAX package's ``repro.ckpt.checkpoint``, with its on-disk
layout).

Layout:  <dir>/step_<N>/arrays.npz + manifest.json (+ .COMMITTED marker).
A checkpoint is valid iff .COMMITTED exists; restore picks the newest valid
step, so a crash mid-save can never poison a restart (atomicity = write to
tmp dir + os.replace + marker last).

Leaves are stored in the reference's order (`core.tree.tree_leaves`: dict
keys sorted, NamedTuple fields in order), so a checkpoint written by either
package restores into the other; `train_state_from_numpy` turns the JAX
package's ``{g, d, gs, ds}`` training state, as numpy, into the port's.
bfloat16 leaves are stored as float32 (numpy has no bfloat16) and cast
back on restore."""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import List, Optional

import numpy as np
import torch

from ..core.tree import tree_leaves, tree_map, tree_unflatten
from ..optim.optimizer import AdamState


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def save(path: str, step: int, tree, extra: Optional[dict] = None) -> str:
    """Atomic synchronous save.  Returns the committed directory."""
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    leaves = [_to_numpy(l) for l in tree_leaves(tree)]
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"a{i}": l for i, l in enumerate(leaves)})
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "dtypes": [str(l.dtype) for l in leaves],
        "shapes": [list(l.shape) for l in leaves],
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    # commit marker written last: partial directories are never "valid"
    with open(os.path.join(final, ".COMMITTED"), "w") as f:
        f.write("ok")
    return final


def valid_steps(path: str) -> List[int]:
    if not os.path.isdir(path):
        return []
    out = []
    for d in os.listdir(path):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(path, d, ".COMMITTED")):
                out.append(int(d.split("_")[1]))
    return sorted(out)


def _like(arr: np.ndarray, ref):
    """``arr`` as ``ref``'s kind of leaf: a tensor of its dtype on its
    device, else a numpy array of its dtype."""
    if isinstance(ref, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(
            device=ref.device, dtype=ref.dtype)
    return np.asarray(arr).astype(np.asarray(ref).dtype)


def restore(path: str, tree_like, step: Optional[int] = None):
    """Restore the newest (or the given) valid checkpoint into
    ``tree_like``'s structure, each leaf in its template's dtype and on its
    device.  Every leaf's shape must equal its template's (several leaves
    share a shape, so an order mismatch that a reshape would hide is
    refused).  Returns (tree, step, extra) or (None, -1, {}) when nothing
    is valid."""
    steps = valid_steps(path)
    if not steps:
        return None, -1, {}
    step = step if step is not None else steps[-1]
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "arrays.npz")) as data:
        leaves = [data[f"a{i}"] for i in range(manifest["n_leaves"])]
    ref_leaves = tree_leaves(tree_like)
    if len(ref_leaves) != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, model "
                         f"expects {len(ref_leaves)}")
    for i, (l, r) in enumerate(zip(leaves, ref_leaves)):
        if tuple(l.shape) != tuple(r.shape):
            raise ValueError(f"checkpoint leaf {i} has shape "
                             f"{tuple(l.shape)}, the model's "
                             f"{tuple(r.shape)}")
    restored = [_like(l, r) for l, r in zip(leaves, ref_leaves)]
    return tree_unflatten(tree_like, restored), step, manifest["extra"]


def retain(path: str, keep: int) -> None:
    steps = valid_steps(path)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(path, f"step_{s:08d}"), ignore_errors=True)


class AsyncCheckpointer:
    """Background-thread checkpointing: the device-to-host copy happens on
    the caller (it cannot race later updates of live tensors), the
    serialisation on a thread.  `wait()` joins the in-flight save and
    raises its error, if any (call it before exit)."""

    def __init__(self, path: str, keep: int = 3):
        self.path = path
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree, extra: Optional[dict] = None):
        self.wait()
        host_tree = tree_map(_to_numpy, tree)

        def work():
            try:
                save(self.path, step, host_tree, extra)
                retain(self.path, self.keep)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def train_state_from_numpy(tree, device="cuda"):
    """The port's training state from the JAX package's (e.g. its WGAN
    ``{"g", "d", "gs", "ds"}``) as numpy arrays: dicts stay dicts, a
    ``(step, mu, nu)`` NamedTuple becomes `optim.AdamState`, other tuples
    stay tuples, and each array becomes a tensor on ``device`` of its own
    dtype (float32 params and moments, an int32 step)."""
    if isinstance(tree, dict):
        return {k: train_state_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        kids = [train_state_from_numpy(v, device) for v in tree]
        if getattr(tree, "_fields", None) == AdamState._fields:
            return AdamState(*kids)
        return tuple(kids)
    return torch.from_numpy(np.array(tree)).to(device)
