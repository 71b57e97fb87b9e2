"""The plain reference against a loop over taps, and the control (the
reference in TF32) against the check's limit, at the configurations'
published widths on a few images."""
import numpy as np
import pytest
import torch

from benchkit import spec


def family_and_config(name):
    cfg = spec.load_config(spec.load_benchmark(), name)
    return spec.load_module("configs", cfg["family"]), cfg


def loop_forward(cfg, weights, z):
    """The towers' definition, one tap at a time, in float64."""
    x = z.astype(np.float64).reshape(z.shape[0], 1, 1, -1)     # NHWC
    for spec_, (w, b) in zip(cfg["layers"], weights):
        w, b = w.double().numpy(), b.double().numpy()
        k, s, p = spec_["kernel"], spec_["stride"], spec_["padding"]
        n, h, _, _ = x.shape
        o = (h - 1) * s - 2 * p + k
        y = np.zeros((n, o, o, spec_["c_out"])) + b
        for ih in range(h):
            for iw in range(h):
                for kh in range(k):
                    for kw in range(k):
                        oh, ow = ih * s - p + kh, iw * s - p + kw
                        if 0 <= oh < o and 0 <= ow < o:
                            y[:, oh, ow] += x[:, ih, iw] @ w[kh, kw]
        x = np.tanh(y) if spec_["activation"] == "tanh" else np.maximum(y, 0)
    return x


TINY = {"name": "tiny", "z_dim": 6, "img_hw": 10, "img_c": 2,
        "layers": [
            {"c_in": 6, "c_out": 5, "kernel": 4, "stride": 1, "padding": 0,
             "activation": "relu"},
            {"c_in": 5, "c_out": 4, "kernel": 4, "stride": 2, "padding": 1,
             "activation": "relu"},
            {"c_in": 4, "c_out": 2, "kernel": 3, "stride": 1, "padding": 0,
             "activation": "tanh"}]}


def test_reference_matches_the_loop_over_taps():
    fam, _ = family_and_config("dcnn-mnist")
    weights = fam.make_weights(TINY, 3, "cpu")
    z = np.random.default_rng(0).standard_normal((3, 6)).astype(np.float32)
    got = fam.forward(TINY, weights, torch.from_numpy(z)).numpy()
    assert got.shape == (3, 10, 10, 2)
    np.testing.assert_allclose(got, loop_forward(TINY, weights, z),
                               atol=1e-6)
    assert fam.max_abs_err(TINY, weights, z, got, "cpu") == 0.0
    assert fam.max_abs_err(TINY, weights, z, got[:2], "cpu") == np.inf


def test_weights_come_from_the_seed_with_nonzero_biases():
    fam, cfg = family_and_config("dcnn-mnist")
    a = fam.make_weights(cfg, 2**40 + 5, "cpu")
    b = fam.make_weights(cfg, 2**40 + 5, "cpu")
    assert all(torch.equal(x, y) for (x, _), (y, _) in zip(a, b))
    for (w, bias), l in zip(a, fam.layers(cfg)):
        assert tuple(w.shape) == (l["kernel"], l["kernel"], l["c_in"],
                                  l["c_out"])
        assert (bias != 0).all() and bias.dtype == torch.float32


def test_tf32_rounds_to_ten_mantissa_bits():
    fam, _ = family_and_config("dcnn-mnist")
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11,
                      -3.0 - 2**-12, 1e-30], dtype=torch.float32)
    r = fam.to_tf32(x)
    assert r.tolist()[:4] == [1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9]
    assert r[4].item() == -3.0
    assert ((r.view(torch.int32) & 0x1FFF) == 0).all()


@pytest.mark.parametrize("seed", [11, 2**31 + 3, 2**35 + 7])
@pytest.mark.parametrize("name,rows", [("dcnn-mnist", 8), ("dcnn-celeba", 2)])
def test_control_fails_the_limit(name, rows, seed):
    """The control, put in the program's place, reads above the limit: a
    float32 program computing in TF32 would be caught."""
    fam, cfg = family_and_config(name)
    weights = fam.make_weights(cfg, seed, "cpu")
    z = np.random.default_rng(seed).standard_normal(
        (rows, cfg["z_dim"])).astype(np.float32)
    control = fam.control_images(cfg, weights, z, "cpu")
    err = fam.max_abs_err(cfg, weights, z, control, "cpu")
    assert err > cfg["limits"]["max_abs_err"]
