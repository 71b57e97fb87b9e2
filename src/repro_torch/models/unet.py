"""The pix2pix U-Net generator ``unet_256`` (Isola et al., "Image-to-Image
Translation with Conditional Adversarial Networks", arXiv:1611.07004,
Appendix 6.1.1; the reference code's ``UnetGenerator(3, 3, 8, ngf=64)``),
served on the port's kernels.

Blocks l = 1 (outermost) .. L = ``num_downs`` (innermost); every conv is
4 x 4, stride 2, padding 1, without bias; LReLU has slope ``slope``:

    h_1 = conv_1(x_1),  h_l = conv_l(LReLU(x_l))          (l >= 2)
    x_{l+1} = IN_l(h_l) for 2 <= l <= L-1, else h_l
    s_{L+1} = x_{L+1};  u_l = IN'_l(convT_l(ReLU(s_{l+1})))
    s_l = cat_C(LReLU(x_l), u_l)                           (l = L .. 2)
    y = tanh(convT_1(ReLU(s_2)) + b)

``IN`` normalises each image's channel over its own H x W (biased
variance, ``eps``) with the affine ``gamma``, ``beta``: pix2pix tests its
BatchNorm in train mode at batch 1, which is this, and per-image
statistics keep an image's result free of its batch mates.  The skip
carries ``LReLU(x_l)`` (the block's in-place LeakyReLU has rectified
``x`` before the cat reads it); ``s_l`` is only ever read through ReLU, so
``ReLU(x_l)`` is what a decoder conv sees of it.  Dropout is left out
(pix2pix keeps it at test time as its noise): the served function is
deterministic.

Params ``{"d{l}": {"w"}, "n{l}": {"g", "b"}  (l = 2 .. L-1),
"u{l}": {"w"}, "m{l}": {"g", "b"}  (l = 2 .. L), "u1": {"w", "b"}}``;
weights HWIO ``(4, 4, C_in, C_out)``: a conv's ``w[kh, kw, ci, co]`` and
a transposed conv's as `models.dcnn` keeps them.  Activations NHWC.

Backends: "reverse_loop" and "cudnn" run plain torch (the encoder convs
through the rewrite below and the reverse loop, or ``F.conv2d``; the
decoder through the reverse loop or ``F.conv_transpose2d``).  "cuda" runs
every conv as one launch of B1 (``kernels.deconv2d``) and every
normalisation and activation as one launch of the norm kernel
(``kernels.norm_act``), on the kernels' plain versions for CPU tensors:

* an encoder conv is zero-pad by 1, space-to-depth by 2 (C -> 4C, H ->
  H/2 + 1) and a 2 x 2 stride-1 valid conv with ``w2[a, b, (p, q, c),
  co] = w[2a + p, 2b + q, c, co]``, which is B1's stride-1 transposed
  conv of the flipped kernel at padding 1 (`b1_weights`, once per
  engine);
* each B1 launch reads its input from a halo-padded buffer that the norm
  kernel fills in place (`_Workspace`): ``LReLU(x_l)`` as the next
  conv's space-to-depth input, ``ReLU(x_l)`` and ``ReLU(u_l)`` as the two
  halves of a decoder conv's input, so the concat costs no copy;
* ``conv_L`` keeps B1's fused ReLU, ``convT_1`` its fused bias and tanh.

One call makes 2L B1 launches (``LAUNCHES["b1_enc"]``,
``LAUNCHES["b1_dec"]``) and 2L - 1 norm-kernel launches
(``LAUNCHES["norm"]``: 2L - 3 normalisations and two in the no-statistics
mode, the input image's space-to-depth and ``h_1``).

Serving only, fp32 only: int8, bf16, the zero-skip kernel, the mesh and
training are refused with a ValueError.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.deconv import deconv2d_reverse_loop, deconv2d_zero_insertion, fp32_exact
from ..core.tiling import DeconvGeometry

BACKENDS = ("reverse_loop", "cuda", "cudnn")
# launches of the "cuda" path by kind, over every call (plain versions too)
LAUNCHES: Dict[str, int] = {"b1_enc": 0, "b1_dec": 0, "norm": 0}


def refuse(what: str) -> ValueError:
    """The error for what the U-Net does not do."""
    return ValueError(f"the pix2pix U-Net serves fp32 on one device through "
                      f"'cuda', 'cudnn' or 'reverse_loop'; {what} is not "
                      "supported")


@dataclasses.dataclass(frozen=True)
class B1Layer:
    """One B1 launch of the "cuda" path, as a plan layer sees it: a
    transposed conv's channels, kernel, stride, padding and fused
    activation (None: none), and whether it is an encoder conv in its
    space-to-depth form."""

    c_in: int
    c_out: int
    kernel: int
    stride: int
    padding: int
    activation: Optional[str]
    encoder: bool


@dataclasses.dataclass(frozen=True)
class UnetConfig:
    """pix2pix's ``unet_256`` at its published sizes by default."""

    name: str = "pix2pix-unet256"
    in_hw: int = 256
    in_c: int = 3
    out_c: int = 3
    ngf: int = 64
    num_downs: int = 8
    eps: float = 1e-5
    slope: float = 0.2
    dtype: str = "float32"

    def __post_init__(self):
        if self.dtype != "float32":
            raise refuse(f"dtype {self.dtype!r}")
        if self.num_downs < 2 or self.in_hw % (1 << self.num_downs):
            raise ValueError(f"{self.name}: {self.num_downs} stride-2 downs "
                             f"need an input a multiple of "
                             f"{1 << max(self.num_downs, 0)}, not "
                             f"{self.in_hw}")

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.float32

    @property
    def input_shape(self) -> Tuple[int, int, int]:
        return (self.in_hw, self.in_hw, self.in_c)

    @property
    def img_hw(self) -> int:
        return self.in_hw

    @property
    def img_c(self) -> int:
        return self.out_c

    def channels(self) -> List[int]:
        """Output channels of conv_1 .. conv_L: ngf, 2 ngf, 4 ngf, then 8 ngf."""
        return [self.ngf * min(1 << i, 8) for i in range(self.num_downs)]

    @property
    def layers(self) -> Tuple[B1Layer, ...]:
        """The 2L B1 launches in order: conv_1 .. conv_L, then convT_L ..
        convT_1."""
        ch, big_l = self.channels(), self.num_downs
        out = []
        c_in = self.in_c
        for l in range(1, big_l + 1):
            out.append(B1Layer(4 * c_in, ch[l - 1], 2, 1, 1,
                               "relu" if l == big_l else None, True))
            c_in = ch[l - 1]
        for l in range(big_l, 0, -1):
            cin = ch[l - 1] * (1 if l == big_l else 2)
            cout = self.out_c if l == 1 else ch[l - 2]
            out.append(B1Layer(cin, cout, 4, 2, 1,
                               "tanh" if l == 1 else None, False))
        return tuple(out)

    def geometries(self) -> List[DeconvGeometry]:
        """Each B1 launch's transposed-conv geometry: an encoder conv's
        input is its space-to-depth map, H/2 + 1 wide."""
        out, hw = [], self.in_hw
        for l in self.layers:
            if l.encoder:
                g = DeconvGeometry(hw // 2 + 1, hw // 2 + 1, l.c_in, l.c_out,
                                   l.kernel, l.stride, l.padding)
            else:
                g = DeconvGeometry(hw, hw, l.c_in, l.c_out, l.kernel,
                                   l.stride, l.padding)
            out.append(g)
            hw = g.out_h
        return out

    def feeds(self) -> Tuple[Tuple[Tuple[int, bool], ...], ...]:
        """What each B1 launch reads (`plan.NetworkPlan.feeds`): conv_1 the
        image's space-to-depth, conv_l that of conv_{l-1}'s map, convT_L
        conv_L's map, and convT_l (l < L) conv_l's map (the skip,
        x_{l+1}) joined with convT_{l+1}'s."""
        big_l = self.num_downs
        out = [((i - 1, True),) for i in range(big_l)]
        out.append(((big_l - 1, False),))
        for m in range(1, big_l):
            out.append(((big_l - 1 - m, False), (big_l + m - 1, False)))
        return tuple(out)


PIX2PIX_UNET256 = UnetConfig()


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def unet_shapes(cfg: UnetConfig) -> Dict[str, Dict[str, tuple]]:
    ch, big_l = cfg.channels(), cfg.num_downs
    shapes: Dict[str, Dict[str, tuple]] = {}
    c_in = cfg.in_c
    for l in range(1, big_l + 1):
        shapes[f"d{l}"] = {"w": (4, 4, c_in, ch[l - 1])}
        if 2 <= l <= big_l - 1:
            shapes[f"n{l}"] = {"g": (ch[l - 1],), "b": (ch[l - 1],)}
        c_in = ch[l - 1]
    for l in range(big_l, 1, -1):
        cin = ch[l - 1] * (1 if l == big_l else 2)
        shapes[f"u{l}"] = {"w": (4, 4, cin, ch[l - 2])}
        shapes[f"m{l}"] = {"g": (ch[l - 2],), "b": (ch[l - 2],)}
    shapes["u1"] = {"w": (4, 4, 2 * ch[0], cfg.out_c), "b": (cfg.out_c,)}
    return shapes


def unet_param_count(cfg: UnetConfig) -> int:
    """Parameters, counted from the shapes (nothing is allocated)."""
    total = 0
    for leaves in unet_shapes(cfg).values():
        for shape in leaves.values():
            n = 1
            for d in shape:
                n *= d
            total += n
    return total


def unet_init(generator: torch.Generator, cfg: UnetConfig, device,
              w_std: float = 0.02, g_std: float = 0.02,
              b_std: float = 0.0) -> Dict[str, Dict[str, torch.Tensor]]:
    """Random params on ``device`` as pix2pix's ``init_weights`` draws
    them: weights N(0, w_std), gamma N(1, g_std), beta and the head's bias
    N(0, b_std) (pix2pix: 0), drawn on the CPU from ``generator``."""
    p: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, leaves in unet_shapes(cfg).items():
        p[key] = {}
        for name, shape in leaves.items():
            v = torch.randn(shape, generator=generator, dtype=torch.float32)
            if name == "w":
                v = v * w_std
            elif name == "g":
                v = 1.0 + v * g_std
            else:
                v = v * b_std
            p[key][name] = v.to(device)
    return p


def s2d_weight(w: torch.Tensor) -> torch.Tensor:
    """A 4 x 4 stride-2 conv's weight ``(4, 4, C, Co)`` as the 2 x 2
    stride-1 conv on the space-to-depth input: ``w2[a, b, (p * 2 + q) *
    C + c, co] = w[2a + p, 2b + q, c, co]``."""
    k, _, c, co = w.shape
    w2 = w.reshape(2, 2, 2, 2, c, co)              # (a, p, b, q, c, co)
    return w2.permute(0, 2, 1, 3, 4, 5).reshape(2, 2, 4 * c, co)


def conv_as_deconv_weight(w2: torch.Tensor) -> torch.Tensor:
    """A stride-1 valid conv's weight as the stride-1 transposed conv's at
    padding K - 1: the kernel flipped."""
    return w2.flip(0, 1).contiguous()


def b1_weights(p, cfg: UnetConfig) -> List[Dict[str, Optional[torch.Tensor]]]:
    """Per B1 launch, in order, ``{"w", "b"}`` in B1's transposed-conv
    layout: the encoder weights rearranged (`s2d_weight`, flipped), the
    decoder's as they are; only the head has a bias."""
    big_l = cfg.num_downs
    out = [{"w": conv_as_deconv_weight(s2d_weight(p[f"d{l}"]["w"])),
            "b": None} for l in range(1, big_l + 1)]
    out += [{"w": p[f"u{l}"]["w"], "b": p[f"u{l}"].get("b")}
            for l in range(big_l, 0, -1)]
    return out


def _check_params(p, cfg: UnetConfig) -> None:
    want = unet_shapes(cfg)
    if set(p) != set(want):
        raise ValueError(f"{cfg.name} expects params {sorted(want)}, got "
                         f"{sorted(p)}")
    for key, leaves in want.items():
        for name, shape in leaves.items():
            got = tuple(p[key][name].shape)
            if got != shape:
                raise ValueError(f"{cfg.name} {key}.{name}: expected shape "
                                 f"{shape}, got {got}")


# ---------------------------------------------------------------------------
# The plain paths
# ---------------------------------------------------------------------------
def _lrelu(v: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(v > 0, v, v * slope)


def _conv_down(x: torch.Tensor, w: torch.Tensor, backend: str) -> torch.Tensor:
    if backend == "cudnn":
        fp32_exact(x.device)
        y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                     stride=2, padding=1)
        return y.permute(0, 2, 3, 1)
    from ..kernels.norm_act import space_to_depth

    return deconv2d_reverse_loop(space_to_depth(x),
                                 conv_as_deconv_weight(s2d_weight(w)), None,
                                 1, 1)


def _conv_up(x: torch.Tensor, w: torch.Tensor, b, backend: str) -> torch.Tensor:
    if backend == "cudnn":
        return deconv2d_zero_insertion(x, w, b, 2, 1)
    return deconv2d_reverse_loop(x, w, b, 2, 1)


def _apply_plain(p, cfg: UnetConfig, x: torch.Tensor,
                 backend: str) -> torch.Tensor:
    from ..kernels.norm_act import normalize

    big_l, eps, slope = cfg.num_downs, cfg.eps, cfg.slope
    skips = []
    h = _conv_down(x, p["d1"]["w"], backend)
    for l in range(2, big_l + 1):
        xl = h if l == 2 else normalize(h, p[f"n{l - 1}"]["g"],
                                        p[f"n{l - 1}"]["b"], eps)
        a = _lrelu(xl, slope)
        skips.append(a)
        h = _conv_down(a, p[f"d{l}"]["w"], backend)
    s = h
    for l in range(big_l, 1, -1):
        u = normalize(_conv_up(torch.relu(s), p[f"u{l}"]["w"], None, backend),
                      p[f"m{l}"]["g"], p[f"m{l}"]["b"], eps)
        s = torch.cat([skips[l - 2], u], dim=3)
    return torch.tanh(_conv_up(torch.relu(s), p["u1"]["w"], p["u1"]["b"],
                               backend))


# ---------------------------------------------------------------------------
# The kernel path
# ---------------------------------------------------------------------------
class _Workspace:
    """The halo-padded input buffer of each B1 launch at one batch,
    allocated zero once and kept: the norm kernel writes only the map's
    places, so halos, padding rings and padded channels stay zero from call
    to call (a serving engine keeps one per bucket; its graph holds their
    addresses)."""

    def __init__(self, plan, device):
        from ..core.offsets import make_phase_plan

        self.plan = plan
        self.inputs, self.launch = [], []
        for layer in plan.layers:
            g, t = layer.geometry, layer.tiles
            (oh, ow, ohp, owp, pad_l, pad_rh, pad_rw, cip, cop, t_n,
             np_) = layer.padded_geometry()
            self.inputs.append(torch.zeros(
                (np_, pad_l + g.in_h + pad_rh, pad_l + g.in_w + pad_rw, cip),
                dtype=torch.float32, device=device))
            self.launch.append((pad_l, (cip, cop), dict(
                plan=make_phase_plan(g.kernel, g.stride, g.padding),
                ih=g.in_h, iw=g.in_w, ohp=ohp, owp=owp, t_oh=t.t_oh,
                t_ow=t.t_ow, t_ci=t.t_ci, t_co=t.t_co, t_n=t_n,
                activation=layer.activation)))


def _apply_cuda(p, cfg: UnetConfig, x: torch.Tensor, plan, prepared,
                workspace) -> torch.Tensor:
    from ..kernels.deconv2d.kernel import deconv2d_launch
    from ..kernels.deconv2d.ops import prepare_static
    from ..kernels.norm_act import Dest, norm_act

    n = x.shape[0]
    big_l, eps, slope = cfg.num_downs, cfg.eps, cfg.slope
    if workspace is None:
        workspace = {}
    ws = workspace.get("buffers")
    if ws is None or ws.plan is not plan:
        ws = workspace["buffers"] = _Workspace(plan, x.device)
    weights = None
    geoms = cfg.geometries()

    def b1(i: int) -> torch.Tensor:
        """Launch i on its input buffer; its map (a view of the padded
        output)."""
        nonlocal weights
        pad_l, (cip, cop), kw = ws.launch[i]
        st = (prepared or {}).get(i)
        if st is None:
            if weights is None:
                weights = b1_weights(p, cfg)
            st = prepare_static(weights[i]["w"], weights[i]["b"], cip, cop)
        y = deconv2d_launch(ws.inputs[i], st.w, st.b, wt=st.wt, **kw)
        LAUNCHES["b1_enc" if i < big_l else "b1_dec"] += 1
        g = geoms[i]
        return y[:n, :g.out_h, :g.out_w, :g.c_out]

    def dest(i: int, off: int = 0, act: float = 0.0, s2d: bool = False):
        return Dest(ws.inputs[i], ws.launch[i][0], off, act, s2d)

    def norm(src, dests, key=None):
        g = b = None
        if key is not None:
            g, b = p[key]["g"], p[key]["b"]
        norm_act(src, dests, g, b, eps)
        LAUNCHES["norm"] += 1

    # the image as conv_1's space-to-depth input
    norm(x, [dest(0, act=1.0, s2d=True)])
    for j in range(big_l - 1):
        # h_{j+1} -> x_{j+2}: LReLU into conv_{j+2}'s input, ReLU into the
        # skip half of convT_{j+1}'s
        h = b1(j)
        norm(h, [dest(j + 1, act=slope, s2d=True), dest(2 * big_l - 1 - j)],
             None if j == 0 else f"n{j + 1}")
    # conv_L's fused ReLU is convT_L's whole input
    h = b1(big_l - 1)
    pad = ws.launch[big_l][0]
    ws.inputs[big_l][:n, pad:pad + h.shape[1], pad:pad + h.shape[2],
                     :h.shape[3]] = h
    for m in range(big_l - 1):
        l = big_l - m
        u = b1(big_l + m)
        # u_l -> ReLU into the up half of convT_{l-1}'s input
        norm(u, [dest(big_l + m + 1, off=u.shape[3])], f"m{l}")
    return b1(2 * big_l - 1)


def unet_apply(p, cfg: UnetConfig, x: torch.Tensor,
               backend: str = "reverse_loop", plan=None, prepared=None,
               workspace: Optional[dict] = None) -> torch.Tensor:
    """Images ``(B, in_hw, in_hw, in_c)`` -> ``(B, in_hw, in_hw, out_c)``
    in [-1, 1], on the device of ``x``.

    ``plan`` is an fp32 `plan.NetworkPlan` of ``cfg`` (`cfg.layers`) at
    this batch: its backend and tiles are used (on "cuda" without one, the
    tiles of `autotune.hopper_tiles` at this batch).  ``prepared`` maps B1
    launch index -> `kernels.deconv2d.ops.StaticOperands` of `b1_weights`
    for the plan's tiles (a serving engine prepares them once);
    ``workspace`` is a dict that keeps the "cuda" path's input buffers
    between calls at one batch (a serving engine keeps one per bucket).

    No autograd: with grad mode on and a param that requires grad it
    raises (the U-Net does not train here)."""
    if plan is not None:
        if plan.precision != "fp32":
            raise refuse(f"precision {plan.precision!r}")
        plan.validate_for(cfg)
        backend = plan.backend
    if backend not in BACKENDS:
        raise refuse(f"backend {backend!r}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for leaves in p.values() for t in leaves.values()):
        raise refuse("training")
    _check_params(p, cfg)
    if x.ndim != 4 or tuple(x.shape[1:]) != cfg.input_shape:
        raise ValueError(f"{cfg.name} expects images shaped (B, "
                         f"{cfg.in_hw}, {cfg.in_hw}, {cfg.in_c}); got "
                         f"{tuple(x.shape)}")
    x = x.to(torch.float32)
    if backend != "cuda":
        return _apply_plain(p, cfg, x, backend)
    if plan is None:
        from ..plan import build_network_plan

        plan = build_network_plan(cfg, batch=x.shape[0], backend="cuda",
                                  autotune=False)
    if plan.batch != x.shape[0]:
        raise ValueError(f"a plan for batch {plan.batch} run on "
                         f"{x.shape[0]} images")
    return _apply_cuda(p, cfg, x.contiguous(), plan, prepared, workspace)
