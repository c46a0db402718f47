"""The port's ops (afcm_tpu_torch.ops) against the JAX package's, on CPU.

Same numpy inputs through both; fp32 throughout. The plain filtered_lrelu is
held against the JAX composition and against the JAX Pallas kernel K1 in
interpret mode (as tests/test_pallas_mxu.py runs it), for the four filter
variants of the shipped generator at small sizes. The CUDA kernel itself
runs only on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from afcm_tpu import ops as jops  # noqa: E402
from afcm_tpu.nn import stylegan3 as jsg3  # noqa: E402
from afcm_tpu.ops.pallas.filtered_lrelu_mxu import filtered_lrelu_mxu  # noqa: E402
from afcm_tpu_torch import ops as tops  # noqa: E402
from afcm_tpu_torch.nn import stylegan3 as tsg3  # noqa: E402
from afcm_tpu_torch.ops.cuda import filtered_lrelu as k1  # noqa: E402

torch.set_num_threads(1)

# Tier-1 contract of tests/test_pallas_mxu.py:56-57.
TOL = dict(atol=1e-4, rtol=1e-4)

# (img_resolution, channel_base, channel_max, num_layers, margin, skip_res)
LAYOUTS = {
    "shipped": (256, 16384, 512, 14, 10, 128),
    "tiny": (64, 1024, 16, 8, 10, 32),
}

# The filtered_lrelu variants of the shipped generator (A-D) at small C and
# sizes; the input carries the +2 of the full 3x3 conv.
VARIANTS = {
    "A_u2d2": dict(size=38, c=3, up=2, down=2, ntu=12, ntd=12, pad=(9, 8, 9, 8)),
    "B_u2d4": dict(size=54, c=2, up=2, down=4, ntu=12, ntd=24,
                   pad=(34, 33, 34, 33)),
    "C_u4d2": dict(size=38, c=2, up=4, down=2, ntu=24, ntd=12,
                   pad=(-6, -9, -6, -9)),
    "D_crop": dict(size=70, c=2, up=2, down=2, ntu=12, ntd=12,
                   pad=(-11, -12, -11, -12)),
}


def _variant_inputs(cfg, seed=0):
    rng = np.random.RandomState(seed)
    fu = jops.design_lowpass_filter(cfg["ntu"], cutoff=cfg["size"] / 4,
                                    width=cfg["size"] / 4,
                                    fs=cfg["size"] * cfg["up"])
    fd = jops.design_lowpass_filter(cfg["ntd"], cutoff=cfg["size"] / 4,
                                    width=cfg["size"] / 4,
                                    fs=cfg["size"] * cfg["up"])
    x = rng.randn(2, cfg["c"], cfg["size"], cfg["size"]).astype(np.float32)
    b = rng.randn(cfg["c"]).astype(np.float32)
    return fu, fd, x, b


def _layout(name):
    res, base, cmax, layers, margin, skip = LAYOUTS[name]
    args = (res, 4, 1, base, cmax, layers, 2, 2.0, 2 ** 2.1, 2 ** 0.3, margin,
            0.25, skip)
    return jsg3.compute_synthesis_layout(*args), tsg3.compute_synthesis_layout(*args)


@pytest.mark.parametrize("numtaps,cutoff,width,fs,radial", [
    (12, 8.0, 9.1, 64, False), (24, 128.0, 53.3, 1024, False),
    (1, 4.0, 4.0, 32, False), (6, 6.0, 5.0, 32, True)])
def test_filter_design_equals_jax(numtaps, cutoff, width, fs, radial):
    from afcm_tpu.ops import filter_design as jfd
    from afcm_tpu_torch.ops import filter_design as tfd
    want = jfd.design_lowpass_filter(numtaps, cutoff, width, fs, radial)
    got = tfd.design_lowpass_filter(numtaps, cutoff, width, fs, radial)
    if want is None:
        assert got is None
        return
    np.testing.assert_array_equal(got, want)
    assert tfd.filter_size(got) == jfd.filter_size(want)
    np.testing.assert_array_equal(tfd.setup_filter([1, 3, 3, 1], gain=4),
                                  jfd.setup_filter([1, 3, 3, 1], gain=4))


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_layout_and_filters_equal_jax(name):
    want, got = _layout(name)
    for field in ("encoder_records", "decoder_skips", "bottleneck_channels",
                  "num_ws", "margin_size", "output_scale"):
        assert getattr(got, field) == getattr(want, field), field
    specs = list(zip(want.encoder_specs + want.decoder_specs,
                     got.encoder_specs + got.decoder_specs))
    assert len(specs) == 2 * LAYOUTS[name][3] + 1
    for w_spec, t_spec in specs:
        assert dataclasses.asdict(t_spec) == dataclasses.asdict(w_spec)
        w_f = jsg3._design_layer_filters(w_spec, w_spec.is_torgb, 6, 2, False)
        t_f = tsg3._design_layer_filters(t_spec, t_spec.is_torgb, 6, 2, False)
        assert t_f[2:] == w_f[2:]                    # up, down, padding
        for t_taps, w_taps in zip(t_f[:2], w_f[:2]):
            if w_taps is None:
                assert t_taps is None
            else:
                np.testing.assert_array_equal(t_taps, w_taps)


def test_shipped_layout_has_five_variants():
    """28 kernel calls per forward in four filter variants, plus toRGB."""
    _, got = _layout("shipped")
    seen = {}
    for spec in got.encoder_specs + got.decoder_specs:
        fu, fd, up, down, pad = tsg3._design_layer_filters(
            spec, spec.is_torgb, 6, 2, False)
        key = (up, down, None if fu is None else len(fu),
               None if fd is None else len(fd), pad)
        seen[key] = seen.get(key, 0) + 1
    assert seen == {(2, 2, 12, 12, (9, 8, 9, 8)): 19,
                    (2, 4, 12, 24, (34, 33, 34, 33)): 4,
                    (4, 2, 24, 12, (-6, -9, -6, -9)): 4,
                    (2, 2, 12, 12, (-11, -12, -11, -12)): 1,
                    (1, 1, None, None, (0, 0, 0, 0)): 1}


def test_filtered_lrelu_output_size_and_fma_match_jax():
    """``ops.filtered_lrelu_output_size`` at every filter variant of the
    shipped generator (and a 2-D filter and a [x, y] padding), equal to the
    shape the op returns; ``ops.fma`` with broadcasting, against JAX's."""
    fu, fd = (tops.design_lowpass_filter(n, cutoff=0.25, width=0.1, fs=2) for n in (12, 24))
    cases = [((36, 36), fu, fu, 2, 2, (9, 8, 9, 8)), ((40, 40), fd, fu, 4, 2, (-6, -9, -6, -9)),
             ((48, 52), fu, fd, 2, 4, (34, 33, 34, 33)), ((70, 70), fu, fu, 2, 2, -11),
             ((9, 11), None, None, 1, 1, 0), ((20, 24), np.outer(fu, fu), fd, 2, 2, [5, 7])]
    for in_size, f_up, f_down, up, down, padding in cases:
        want = jops.filtered_lrelu_output_size(in_size, f_up, f_down, up, down, padding)
        assert tops.filtered_lrelu_output_size(in_size, f_up, f_down, up, down,
                                               padding) == want
    x = torch.from_numpy(np.random.RandomState(3).randn(1, 2, 36, 36).astype(np.float32))
    y = tops.filtered_lrelu(x, fu=fu, fd=fu, up=2, down=2, padding=(9, 8, 9, 8))
    assert tuple(y.shape[2:]) == tops.filtered_lrelu_output_size((36, 36), fu, fu, 2, 2,
                                                                 (9, 8, 9, 8))
    rng = np.random.RandomState(4)
    a, b, c = (rng.randn(*shape).astype(np.float32) for shape in ((3, 1, 5), (4, 1), (5,)))
    np.testing.assert_allclose(
        tops.fma(*map(torch.from_numpy, (a, b, c))).numpy(),
        np.asarray(jops.fma(*map(jnp.asarray, (a, b, c)))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("act,alpha,gain,clamp", [
    ("linear", None, None, None), ("linear", None, 2.0, 1.0),
    ("lrelu", 0.2, np.sqrt(2), 256.0), ("lrelu", 0.2, 1.7, 0.5),
    ("lrelu", None, None, None), ("lrelu", 1.0, 1.0, 256.0),
    *[(act, None, None, None) for act in ("relu", "tanh", "sigmoid", "elu", "selu",
                                          "softplus", "swish")],
    ("swish", None, 1.5, 0.5)])
def test_bias_act_matches_jax(act, alpha, gain, clamp):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 7, 6).astype(np.float32)
    x[0, 0, 0, :3] = 0.0                     # the strict x > 0 rule at zero
    b = rng.randn(5).astype(np.float32)
    want = jops.bias_act(jnp.asarray(x), jnp.asarray(b), act=act, alpha=alpha,
                         gain=gain, clamp=clamp)
    got = tops.bias_act(torch.from_numpy(x), torch.from_numpy(b), act=act,
                        alpha=alpha, gain=gain, clamp=clamp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kw", [
    dict(up=2, padding=(9, 8, 9, 8)),
    dict(down=2, padding=0),
    dict(up=4, padding=(-6, -9, -6, -9), gain=16),
    dict(down=4, padding=(3, 2, 1, 0), flip_filter=True),
    dict(up=(2, 1), down=(1, 2), padding=(-3, 4, 5, -2)),
    dict(up=2, down=2, padding=11, filt2d=True),
], ids=["up2", "down2", "up4_crop", "down4_flip", "mixed_axes", "filter2d"])
def test_upfirdn2d_matches_jax(kw):
    kw = dict(kw)
    rng = np.random.RandomState(2)
    x = rng.randn(2, 3, 20, 18).astype(np.float32)
    f = jops.design_lowpass_filter(12, cutoff=5.0, width=4.0, fs=40)
    if kw.pop("filt2d", False):
        f = np.outer(f, f[::-1])
    want = jops.upfirdn2d(jnp.asarray(x), f, impl="conv", **kw)
    got = tops.upfirdn2d(torch.from_numpy(x), f, **kw)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("demodulate,input_gain", [
    (True, 0.7), (True, "per_sample"), (False, None)])
def test_modulated_conv2d_matches_jax(demodulate, input_gain):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 6, 11, 11).astype(np.float32)
    w = rng.randn(5, 6, 3, 3).astype(np.float32)
    s = rng.randn(2, 6).astype(np.float32)
    if input_gain == "per_sample":
        input_gain = rng.rand(2, 6).astype(np.float32) + 0.5
    want = jops.modulated_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                                 demodulate=demodulate, padding=2,
                                 input_gain=input_gain)
    tgain = input_gain if not isinstance(input_gain, np.ndarray) \
        else torch.from_numpy(input_gain)
    got = tops.modulated_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(s), demodulate=demodulate,
                                padding=2, input_gain=tgain)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_conv2d_resample_matches_jax():
    """e_16x16's path (up = down = 1, 2-D resample filter unused) and a
    strided-down case."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 4, 12, 12).astype(np.float32)
    w = rng.randn(3, 4, 3, 3).astype(np.float32)
    f = jops.setup_filter([1, 3, 3, 1])
    for kw in (dict(padding=1), dict(down=2, padding=1)):
        want = jops.conv2d_resample(jnp.asarray(x), jnp.asarray(w), f=f, **kw)
        got = tops.conv2d_resample(torch.from_numpy(x), torch.from_numpy(w),
                                   f=f, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_filtered_lrelu_matches_jax_composition_and_pallas(name):
    cfg = VARIANTS[name]
    fu, fd, x, b = _variant_inputs(cfg)
    kw = dict(up=cfg["up"], down=cfg["down"], padding=cfg["pad"],
              gain=np.sqrt(2), slope=0.2, clamp=256)
    want_xla = np.asarray(jops.filtered_lrelu(
        jnp.asarray(x), fu=fu, fd=fd, b=jnp.asarray(b), impl="xla", **kw))
    want_k1 = np.asarray(filtered_lrelu_mxu(
        jnp.asarray(x), fu, fd, jnp.asarray(b), cfg["up"], cfg["down"],
        cfg["pad"], float(np.sqrt(2)), 0.2, 256.0, False, interpret=True))
    launches = k1.launches
    got = tops.filtered_lrelu(torch.from_numpy(x), fu=fu, fd=fd,
                              b=torch.from_numpy(b), **kw).numpy()
    assert got.shape == want_xla.shape == want_k1.shape
    np.testing.assert_allclose(got, want_xla, **TOL)
    np.testing.assert_allclose(got, want_k1, **TOL)
    assert k1.launches == launches      # a CPU tensor never reaches the kernel


def test_filtered_lrelu_torgb_is_elementwise():
    """toRGB (no filters, up = down = 1) is plain torch on every device."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 1, 9, 9).astype(np.float32)
    b = rng.randn(1).astype(np.float32)
    kw = dict(up=1, down=1, padding=0, gain=1, slope=1, clamp=256)
    want = jops.filtered_lrelu(jnp.asarray(x), b=jnp.asarray(b), **kw)
    got = tops.filtered_lrelu(torch.from_numpy(x), b=torch.from_numpy(b), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cuda_wrapper_rejects_cpu_tensors():
    """The kernel wrapper launches or raises; it never computes on the CPU."""
    x = torch.zeros(1, 2, 8, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        k1.filtered_lrelu_cuda(x, fu=np.ones(2, np.float32), up=2)
    with pytest.raises(NotImplementedError, match="separable"):
        k1._correlation_taps(np.ones((3, 3), np.float32), 1.0, False)


def test_round1_goldens():
    """The JAX package's round-1 goldens; 1e-5 because torch sums the taps
    in another order than XLA."""
    import os
    g = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                             "round1_goldens.npz"))
    x = torch.from_numpy(g["ops_x"])
    got = tops.upfirdn2d(x, g["ops_fu"], up=2, down=2, padding=11, gain=1.0)
    np.testing.assert_allclose(got.numpy(), g["ops_upfirdn"], rtol=1e-5, atol=1e-5)
    got = tops.filtered_lrelu(x, fu=g["ops_fu"], fd=g["ops_fd"],
                              b=torch.from_numpy(g["ops_b"]), up=2, down=2,
                              padding=11, gain=np.sqrt(2), clamp=256)
    np.testing.assert_allclose(got.numpy(), g["ops_flrelu"], rtol=1e-5, atol=1e-5)
    assert k1.launches == 0
