"""WGAN-GP training (Gulrajani et al.): the framework the paper uses to
train both DCNNs (Fig. 4); the JAX package's ``repro.train.wgan`` in torch.

`WganTrainer` is the training-side mirror of `serve.DcnnServeEngine`:

* **Bucketed steps.**  Ragged batch sizes are rounded up to power-of-two
  buckets (padded ``real`` rows are masked out of the loss with exact
  sum/n_valid accounting; the generator's z batch is drawn at the bucket
  size), so each bucket's step and plan are built once.  ``build_counts``
  shows it.  Steps run eagerly.
* **z shards.**  ``z_shards=n`` runs the reference's per-shard math on one
  device: each shard draws its own noise and owns an equal sub-batch, and
  the shards' losses and grads are summed before one optimizer update
  (the single-device form of the reference's mesh-sharded step; meshes
  wait for the multi-device port).
* **The kernel in the generator's forward.**  ``backend="cuda"`` runs the
  generator's forward through the serving kernel (one B1 launch per
  layer, at the tiles of the bucket's plan, built for the per-shard
  sub-batch) with the reverse loop's autograd as its backward
  (`models.dcnn.make_fused_generator`).  "reverse_loop" (the default)
  and "cudnn" are the plain differentiable formulations.
* **Noise.**  ``critic_step``/``gen_step`` take a ``key``, a tuple of ints
  such as ``(seed, step, sub_step)``; shard i draws its z (and the
  critic's interpolation weights eps) from a ``torch.Generator`` on the
  params' device seeded from ``key + (i,)``, so a resumed run draws what
  the uninterrupted one drew.  ``critic_update``/``gen_update`` take the
  noise tensors themselves.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..core.tree import tree_leaves, tree_map, tree_unflatten
from ..models.dcnn import (DcnnConfig, critic_apply, critic_init,
                           generator_apply, generator_init,
                           make_fused_generator)

BACKENDS = ("reverse_loop", "cudnn", "cuda")
Key = Union[int, Sequence[int]]


def check_backend(backend: str, plan) -> None:
    """Refuse a backend or pinned plan that cannot train (shared with
    `train.supervised`)."""
    if backend == "cuda_sparse":
        raise ValueError(
            "cuda_sparse is inference-only: the static zero-skip plan is "
            "derived from frozen weights, which training updates each step")
    if backend not in BACKENDS:
        raise ValueError(f"unknown training backend {backend!r}; expected "
                         f"one of {BACKENDS}")
    if plan is not None:
        if backend != "cuda":
            raise ValueError(
                "a pinned NetworkPlan needs backend='cuda' (plans pin the "
                f"serving kernels); got {backend!r}")
        if plan.backend != "cuda" or plan.precision != "fp32":
            raise ValueError(
                "training consumes fp32 cuda plans; got "
                f"backend={plan.backend!r} / precision={plan.precision!r}")


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= n (cf. `serve.engine.pow2_buckets`)."""
    if n < 1:
        raise ValueError(f"batch must be >= 1 (got {n})")
    b = 1
    while b < n:
        b <<= 1
    return b


def bucket_gen_fn(cfg: DcnnConfig, backend: str, batch: int, *,
                  autotune: bool, pinned, counts: Dict[int, int], bucket: int):
    """``(apply(p, x), plan)`` of one bucket's generator forward: on
    "cuda" the fused generator at a plan built for ``batch`` rows (the
    pinned plan where its batch matches, hash-asserted; ``counts[bucket]``
    counts the plans built), else the plain backend and None."""
    if backend != "cuda":
        return (lambda p, x: generator_apply(p, cfg, x, backend=backend)), None
    from ..plan import build_network_plan

    plan = build_network_plan(cfg, batch=batch, backend="cuda",
                              autotune=autotune)
    counts[bucket] = counts.get(bucket, 0) + 1
    if pinned is not None and plan.batch == pinned.batch:
        # the bucket that matches the pinned serving batch must resolve to
        # the identical executable configuration
        if plan.stable_hash() != pinned.stable_hash():
            raise ValueError(
                f"trainer-built plan for batch {batch} "
                f"({plan.stable_hash()}) does not match the pinned serving "
                f"plan ({pinned.stable_hash()}); training would run other "
                "tiles than serving does: re-pin one side")
        plan = pinned
    return make_fused_generator(cfg, plan=plan), plan


def as_batch(a, device, dtype) -> torch.Tensor:
    """A numpy batch (or a tensor) as a tensor on ``device`` in ``dtype``."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.asarray(a, dtype=np.float32))
    return a.to(device=device, dtype=dtype)


def pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """``t`` with zero rows appended up to ``rows``."""
    if rows == t.shape[0]:
        return t
    return torch.cat([t, t.new_zeros((rows - t.shape[0],) + t.shape[1:])])


def noise_generator(device, key: Key, shard: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``key + (shard,)``."""
    ints = [int(k) for k in (key if isinstance(key, (tuple, list))
                             else (key,))] + [int(shard)]
    seed = int(np.random.SeedSequence(ints).generate_state(1, np.uint64)[0])
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(seed >> 1)
    return g


def requiring_grad(tree):
    """Detached copies of ``tree``'s tensors that require grad."""
    return tree_map(lambda t: t.detach().requires_grad_(), tree)


def critic_loss(dp, gp_params, cfg: DcnnConfig, real, z, eps, gp_coef=10.0,
                mask=None, n_valid=None, gen_fn=None):
    """WGAN-GP critic loss and ``{"wdist", "gp"}``.

    ``eps`` ``(B, 1, 1, 1)`` are the interpolation weights of the gradient
    penalty (the reference draws them from its key).  The fake batch is
    made without a graph.  With ``mask``/``n_valid`` the means become
    ``sum(mask * term) / n_valid``: pad rows of a bucketed batch contribute
    exactly zero, and per-shard values sum to the whole batch's loss."""
    gen = gen_fn if gen_fn is not None else (
        lambda p, z_: generator_apply(p, cfg, z_))
    with torch.no_grad():
        fake = gen(gp_params, z)
    d_real = critic_apply(dp, cfg, real)
    d_fake = critic_apply(dp, cfg, fake)
    # gradient penalty on interpolates
    x_hat = (eps * real + (1.0 - eps) * fake).requires_grad_()
    grad_x, = torch.autograd.grad(critic_apply(dp, cfg, x_hat).sum(), x_hat,
                                  create_graph=True)
    gnorm = torch.sqrt(torch.sum(grad_x ** 2, dim=(1, 2, 3)) + 1e-12)
    if mask is None:
        wdist = torch.mean(d_real) - torch.mean(d_fake)
        gp = torch.mean((gnorm - 1.0) ** 2)
    else:
        wdist = (torch.sum(d_real * mask) - torch.sum(d_fake * mask)) / n_valid
        gp = torch.sum(((gnorm - 1.0) ** 2) * mask) / n_valid
    loss = -wdist + gp_coef * gp
    return loss, {"wdist": wdist, "gp": gp}


def generator_loss(gp_params, dp, cfg: DcnnConfig, z, gen_fn=None,
                   denom=None):
    """-E[critic(G(z))]; ``denom`` replaces the local mean with a given
    divisor so per-shard losses sum to the whole batch's."""
    gen = gen_fn if gen_fn is not None else (
        lambda p, z_: generator_apply(p, cfg, z_))
    scores = critic_apply(dp, cfg, gen(gp_params, z))
    if denom is None:
        return -torch.mean(scores)
    return -torch.sum(scores) / denom


def _add(acc, new):
    return new if acc is None else [a + b for a, b in zip(acc, new)]


class WganTrainer:
    """Bucketed WGAN-GP trainer (see the module doc).

    ``critic_step(dp, d_state, gp, real, key)`` and ``gen_step(gp, g_state,
    dp, key, batch)`` return ``(params, opt_state, metrics)``; padding,
    bucketing, z shards and the per-bucket steps and plans are behind
    them.  Params live on ``device`` (default the card)."""

    def __init__(self, cfg: DcnnConfig, g_opt, d_opt, *,
                 n_critic: int = 5, gp_coef: float = 10.0,
                 backend: str = "reverse_loop",
                 autotune: bool = True, z_shards: Optional[int] = None,
                 plan=None, device="cuda"):
        if n_critic < 1:
            raise ValueError(
                f"n_critic must be >= 1 (got {n_critic}): the generator "
                "batch is derived from the critic's data batch")
        check_backend(backend, plan)
        if plan is not None:
            plan.validate_for(cfg)
        self.cfg = cfg
        self.g_opt = g_opt
        self.d_opt = d_opt
        self.n_critic = n_critic
        self.gp_coef = gp_coef
        self.backend = backend
        self.device = torch.device(device)
        self._autotune = autotune
        self.shards = z_shards or 1
        self._pinned_plan = plan
        self._critic_fns: Dict[int, Callable] = {}
        self._gen_fns: Dict[int, Callable] = {}
        self._gen_apply: Dict[int, Callable] = {}
        # per kind and bucket, how many times its step / plan was built
        self.build_counts: Dict[str, Dict[int, int]] = {
            "critic": {}, "gen": {}, "plan": {}}
        # bucket -> NetworkPlan the generator forward runs ("cuda" only)
        self.plans: Dict[int, Any] = {}

    # -- bucketing ------------------------------------------------------
    def bucket_for(self, n: int) -> int:
        """Smallest power of two >= n, rounded up to a multiple of the
        shard count so every shard owns an equal sub-batch."""
        b = pow2_bucket(n)
        return -(-b // self.shards) * self.shards

    def _local(self, bucket: int) -> int:
        return bucket // self.shards

    def _check_rows(self, bucket: int, n_valid: int) -> None:
        if bucket % self.shards or not 1 <= n_valid <= bucket:
            raise ValueError(
                f"{bucket} rows ({n_valid} valid) do not split into "
                f"{self.shards} equal shards holding every valid row")

    # -- generator forward for the loss path ----------------------------
    def _gen_for(self, bucket: int) -> Callable:
        """The bucket's generator apply: the fused kernel forward at a plan
        for the per-shard sub-batch, or a plain backend."""
        if bucket not in self._gen_apply:
            fn, plan = bucket_gen_fn(
                self.cfg, self.backend, self._local(bucket),
                autotune=self._autotune, pinned=self._pinned_plan,
                counts=self.build_counts["plan"], bucket=bucket)
            if plan is not None:
                self.plans[bucket] = plan
            self._gen_apply[bucket] = fn
        return self._gen_apply[bucket]

    def _built(self, kind: str, fns: Dict[int, Callable], bucket: int,
               build: Callable[[int], Callable]) -> Callable:
        if bucket not in fns:
            fns[bucket] = build(bucket)
            counts = self.build_counts[kind]
            counts[bucket] = counts.get(bucket, 0) + 1
        return fns[bucket]

    # -- step construction ----------------------------------------------
    def _build_critic_fn(self, bucket: int) -> Callable:
        cfg, gp_coef, d_opt = self.cfg, self.gp_coef, self.d_opt
        local, shards = self._local(bucket), self.shards
        gen_fn = self._gen_for(bucket)

        def body(dp, d_state, gp, real, nv, z, eps):
            dpg = requiring_grad(dp)
            leaves = tree_leaves(dpg)
            mask = (torch.arange(bucket, device=real.device) < nv).to(
                real.dtype)
            loss = met = grads = None
            for i in range(shards):
                sl = slice(i * local, (i + 1) * local)
                l, m = critic_loss(dpg, gp, cfg, real[sl], z[sl], eps[sl],
                                   gp_coef=gp_coef, mask=mask[sl],
                                   n_valid=nv, gen_fn=gen_fn)
                grads = _add(grads, torch.autograd.grad(l, leaves))
                l, m = l.detach(), {k: v.detach() for k, v in m.items()}
                loss = l if loss is None else loss + l
                met = m if met is None else {k: met[k] + m[k] for k in met}
            dp, d_state = d_opt.update(tree_unflatten(dp, grads), d_state, dp)
            return dp, d_state, dict(met, d_loss=loss)

        return body

    def _build_gen_fn(self, bucket: int) -> Callable:
        cfg, g_opt = self.cfg, self.g_opt
        local, shards = self._local(bucket), self.shards
        gen_fn = self._gen_for(bucket)
        denom = float(bucket)

        def body(gp, g_state, dp, z):
            gpg = requiring_grad(gp)
            leaves = tree_leaves(gpg)
            loss = grads = None
            for i in range(shards):
                l = generator_loss(gpg, dp, cfg, z[i * local:(i + 1) * local],
                                   gen_fn=gen_fn, denom=denom)
                grads = _add(grads, torch.autograd.grad(l, leaves))
                loss = l.detach() if loss is None else loss + l.detach()
            gp, g_state = g_opt.update(tree_unflatten(gp, grads), g_state, gp)
            return gp, g_state, {"g_loss": loss}

        return body

    # -- noise ----------------------------------------------------------
    def _draw(self, key: Key, bucket: int, eps: bool):
        """Per shard, z ``(local, z_dim)`` (and eps ``(local, 1, 1, 1)``)
        from the shard's generator; concatenated over the shards."""
        local, dt = self._local(bucket), self.cfg.torch_dtype
        zs, es = [], []
        for i in range(self.shards):
            g = noise_generator(self.device, key, i)
            zs.append(torch.randn((local, self.cfg.z_dim), generator=g,
                                  dtype=dt, device=self.device))
            if eps:
                es.append(torch.rand((local, 1, 1, 1), generator=g, dtype=dt,
                                     device=self.device))
        return torch.cat(zs), (torch.cat(es) if eps else None)

    # -- public steps ----------------------------------------------------
    def critic_step(self, dp, d_state, gp, real, key: Key):
        """One critic update on a (possibly ragged) real batch, numpy or a
        tensor: pads it to its bucket, masks the pad rows out of the loss
        exactly, draws z and eps from ``key``."""
        real = as_batch(real, self.device, self.cfg.torch_dtype)
        n = real.shape[0]
        bucket = self.bucket_for(n)
        real = pad_rows(real, bucket)
        z, eps = self._draw(key, bucket, eps=True)
        return self.critic_update(dp, d_state, gp, real, n, z, eps)

    def critic_update(self, dp, d_state, gp, real, n_valid: int, z, eps):
        """One critic update on ``real`` already padded to its bucket (the
        first ``n_valid`` rows valid), with the given z ``(bucket, z_dim)``
        and eps ``(bucket, 1, 1, 1)``, shard i owning rows
        ``[i*local, (i+1)*local)`` of each."""
        bucket = real.shape[0]
        self._check_rows(bucket, int(n_valid))
        fn = self._built("critic", self._critic_fns, bucket,
                         self._build_critic_fn)
        return fn(dp, d_state, gp, real, int(n_valid), z, eps)

    def gen_step(self, gp, g_state, dp, key: Key, batch: int):
        """One generator update; ``batch`` is rounded up to its bucket and
        z drawn from ``key`` at the bucket size."""
        z, _ = self._draw(key, self.bucket_for(int(batch)), eps=False)
        return self.gen_update(gp, g_state, dp, z)

    def gen_update(self, gp, g_state, dp, z):
        """One generator update with the given z ``(bucket, z_dim)``."""
        bucket = z.shape[0]
        self._check_rows(bucket, bucket)
        fn = self._built("gen", self._gen_fns, bucket, self._build_gen_fn)
        return fn(gp, g_state, dp, z)

    @property
    def total_builds(self) -> int:
        return sum(v for d in self.build_counts.values() for v in d.values())

    def plan_fingerprints(self) -> Dict[int, str]:
        """{per-shard batch -> stable hash} of the plans the generator
        forward ran ("cuda"): compare with a serving engine's ``plans``."""
        from ..plan import executable_fingerprints

        return executable_fingerprints(self.plans.values())

    # -- training loop ----------------------------------------------------
    def init_state(self, seed: int = 0):
        """Random ``(gp, dp, g_state, d_state)`` on the trainer's device,
        drawn on the CPU from ``seed``."""
        g = torch.Generator().manual_seed(seed)
        gp = generator_init(g, self.cfg, self.device)
        dp = critic_init(g, self.cfg, self.device)
        return gp, dp, self.g_opt.init(gp), self.d_opt.init(dp)

    def fit(self, source, steps: int, seed: int = 0, log_every: int = 50,
            ckpt=None, ckpt_every: int = 200,
            resume_from: Optional[str] = None):
        """Train for (up to) ``steps`` steps; returns ``(gp, dp, history)``.

        ``source`` is a step-indexed source (anything exposing
        ``batch(step) -> {"images": ...}``, pure in the step: the resumable
        default) or a *streaming batch iterator*: any iterable of
        ``{"images": ...}`` dicts (or bare image arrays).  A streaming
        source is consumed one batch per critic sub-step and training stops
        when it is exhausted: a finite iterator drains exactly, with no
        batch invented past its end and no unpaired generator update.  Only
        a step-indexed source can replay batches on resume.

        Checkpoints (``ckpt``, an `ckpt.AsyncCheckpointer`) carry generator,
        critic and both optimizer states plus the step, and step ``s``
        sub-step ``j`` draws its noise from key ``(seed, s, j)``, so a run
        resumed from one is bitwise the run that never stopped."""
        gp, dp, g_state, d_state = self.init_state(seed)
        start = 0
        if resume_from is not None:
            from ..ckpt.checkpoint import restore

            tree_like = {"g": gp, "d": dp, "gs": g_state, "ds": d_state}
            tree, step0, extra = restore(resume_from, tree_like)
            if tree is not None:
                gp, dp = tree["g"], tree["d"]
                g_state, d_state = tree["gs"], tree["ds"]
                start = int(extra.get("step", step0)) + 1

        stream = None if hasattr(source, "batch") else iter(source)

        def next_real(step):
            if stream is None:
                return source.batch(step)["images"]
            rec = next(stream, None)
            return rec["images"] if isinstance(rec, dict) else rec

        history: List[dict] = []
        for step in range(start, steps):
            met: Dict[str, Any] = {}
            batch = None
            for j in range(self.n_critic):
                real = next_real(step)
                if real is None:
                    # the stream drained mid-step: stop before an unpaired
                    # generator update
                    return gp, dp, history
                batch = real.shape[0]
                dp, d_state, met_d = self.critic_step(dp, d_state, gp, real,
                                                      (seed, step, j))
                met.update(met_d)
            gp, g_state, met_g = self.gen_step(gp, g_state, dp,
                                               (seed, step, self.n_critic),
                                               batch)
            met.update(met_g)
            if step % log_every == 0 or step == steps - 1:
                history.append({k: float(v) for k, v in met.items()}
                               | {"step": step})
            if ckpt is not None and step % ckpt_every == 0:
                ckpt.save(step, {"g": gp, "d": dp, "gs": g_state,
                                 "ds": d_state}, extra={"step": step})
        return gp, dp, history


def make_wgan_steps(cfg: DcnnConfig, g_opt, d_opt,
                    backend: str = "reverse_loop", **kwargs):
    """Returns ``(critic_step, gen_step)`` of a `WganTrainer` (reachable as
    ``critic_step.__self__``)."""
    trainer = WganTrainer(cfg, g_opt, d_opt, backend=backend, **kwargs)
    return trainer.critic_step, trainer.gen_step


def train_wgan(
    cfg: DcnnConfig,
    source,
    steps: int,
    seed: int,
    g_opt,
    d_opt,
    n_critic: int = 5,
    log_every: int = 50,
    ckpt=None,           # optional AsyncCheckpointer
    ckpt_every: int = 200,
    backend: str = "reverse_loop",
    resume_from: Optional[str] = None,
    device="cuda",
):
    trainer = WganTrainer(cfg, g_opt, d_opt, n_critic=n_critic,
                          backend=backend, device=device)
    return trainer.fit(source, steps, seed, log_every=log_every, ckpt=ckpt,
                       ckpt_every=ckpt_every, resume_from=resume_from)
