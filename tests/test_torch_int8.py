"""The port's int8 3x3 conv path (kernels K3 and K4) against the JAX
package's, on CPU.

A CPU tensor takes the kernel's plain version (``conv3x3_int8_plain``); the
JAX function runs its Pallas kernel in interpret mode, as
tests/test_conv_int8.py does. Inputs are made with numpy from a seed and
handed to both. Tolerances, with their reasons, stand at each test.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from afcm_tpu.nn import Stylegan3Generator as JaxGenerator  # noqa: E402
from afcm_tpu.nn.stylegan3 import compute_synthesis_layout as jax_layout  # noqa: E402
from afcm_tpu.ops import modulated_conv as jmc  # noqa: E402
from afcm_tpu.ops.pallas import conv_int8 as jk3  # noqa: E402
from afcm_tpu_torch.models import CMSR_ADNI_G, build_eval_model  # noqa: E402
from afcm_tpu_torch.nn import Stylegan3Generator  # noqa: E402
from afcm_tpu_torch.ops import modulated_conv as tmc  # noqa: E402
from afcm_tpu_torch.ops.cuda import conv_int8 as k3  # noqa: E402
from afcm_tpu_torch.utils.port import load_jax_variables  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The generator of tests/test_conv_int8.py's guardrail: 128 channels, so
# that the 3x3 convs pass the int8 shape gates.
TINY = dict(z_dim=64, c_dim=1, w_dim=64, img_resolution=64, img_channels_in=4,
            img_channels_out=1, mapping_kwargs=dict(num_layers=2),
            synthesis_kwargs=dict(channel_base=8192, channel_max=128,
                                  num_layers=6, num_critical=2, margin_size=10,
                                  skip_resolution=32, conv_clamp=256))


def _psnr(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.mean((got - want) ** 2)
    dr = float(want.max() - want.min())
    return 10 * np.log10(dr * dr / max(err, 1e-12))


def _conv_case(i, o, h, seed=0, n=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, i, h, h).astype(np.float32)
    w = (rng.randn(o, i, 3, 3) / np.sqrt(9 * i)).astype(np.float32)
    es = (rng.rand(n, o) + 0.5).astype(np.float32)
    return x, w, es


def _bf16_ulp(want):
    """One bf16 unit in the last place at each |want| (8 significand bits)."""
    return np.maximum(2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7),
                      2.0 ** -133)


@pytest.fixture
def int8_mode():
    """Sets the conv implementation of both packages and restores 'xla' and
    the channel floor of 64; the JAX package routes off its device through
    its own test hook."""
    saved = jmc._FORCE_INT8
    jmc._FORCE_INT8 = True

    def set_both(mode, min_ch=64):
        jmc.set_conv_impl(mode, min_ch=min_ch)
        tmc.set_conv_impl(mode, min_ch=min_ch)
    yield set_both
    jmc._FORCE_INT8 = saved
    set_both("xla")


# (a) ---------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["dots", "im2col"])
@pytest.mark.parametrize("i,o,h,p,extra", [
    (48, 40, 20, 1, False),     # 'same' conv, channels below every pad unit
    (64, 64, 24, 2, False),     # full padding, the alias-free layers' form
    (128, 96, 36, 2, False),
    (48, 40, 16, 1, True),      # extra_scale folded into the dequantization
    (91, 64, 12, 0, True),      # no padding, odd channel count
])
def test_conv3x3_int8_matches_jax(variant, i, o, h, p, extra):
    """The quantizers and the integer accumulation are exact in both
    packages, so the bf16 results may differ only where the fp32 scale
    product was fused or ordered differently: at most 1 bf16 ulp at any
    element. Against the fp32 conv: PSNR > 50 dB, the per-layer budget of
    tests/test_conv_int8.py."""
    x, w, es = _conv_case(i, o, h)
    extra_j = jnp.asarray(es) if extra else None
    want = jk3.conv3x3_int8(jnp.asarray(x), jnp.asarray(w), padding=p,
                            extra_scale=extra_j, variant=variant, interpret=True)
    want = np.asarray(want, np.float32)
    got = k3.conv3x3_int8(torch.from_numpy(x), torch.from_numpy(w), padding=p,
                          extra_scale=torch.from_numpy(es) if extra else None)
    assert got.dtype == torch.bfloat16 and not got.requires_grad
    got = got.float().numpy()
    assert got.shape == want.shape == (2, o, h + 2 * p - 2, h + 2 * p - 2)
    assert np.all(np.abs(got - want) <= _bf16_ulp(want))
    ref = F.conv2d(torch.from_numpy(x), torch.from_numpy(w), padding=p).numpy()
    if extra:
        ref = ref * es[:, :, None, None]
    assert _psnr(got, ref) > 50


def _packed_conv_plain(x, w, p, es=None):
    """The conv through the plain versions of the quantizer kernels: the
    packed int8 NHWC activations and the tiled weights, convolved as the
    integers they hold and dequantized as K3's epilogue does."""
    xp, xs = k3.quantize_pack_activations_plain(x, p)
    wp, ws = k3.quantize_pack_weights_plain(w)
    o = w.shape[0]
    taps = k3.unpack_weights(wp).reshape(3, 3, wp.shape[0] * 64, xp.shape[3])
    taps = taps.permute(2, 3, 0, 1)[:o].double()
    acc = F.conv2d(xp.permute(0, 3, 1, 2).double(), taps).to(torch.int32)
    scale = k3.dequant_scale(xs, ws, es)
    return (acc.float() * scale[:, :, None, None]).to(torch.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("i,o,h,p,extra", [
    (48, 40, 20, 1, False),
    (64, 96, 24, 2, True),
    (91, 160, 12, 0, False),    # odd channels: both channel pads hold zeros
])
def test_conv3x3_int8_packed_path_matches_jax(i, o, h, p, extra, dtype):
    """The plain versions of the quantizer kernels, end to end against the
    JAX package's own ``conv3x3_int8`` (whose quantizers are inline): the
    packed operands, convolved as integers, give its result within 1 bf16
    ulp, and the wrapper's CPU path bit for bit. bf16 and fp32 inputs; sample
    1 is all zero (the scale's floor, 1e-8 / 127) and comes out 0."""
    x, w, es = _conv_case(i, o, h, seed=5, n=3)
    x[1] = 0
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    wt = torch.from_numpy(w)
    est = torch.from_numpy(es) if extra else None
    want = jk3.conv3x3_int8(jnp.asarray(xt.float().numpy()).astype(dtype), jnp.asarray(w),
                            padding=p, extra_scale=jnp.asarray(es) if extra else None,
                            interpret=True)
    want = np.asarray(want, np.float32)
    got = _packed_conv_plain(xt, wt, p, est)
    assert torch.equal(got, k3.conv3x3_int8(xt, wt, p, est))
    got = got.float().numpy()
    assert got.shape == want.shape == (3, o, h + 2 * p - 2, h + 2 * p - 2)
    assert np.all(np.abs(got - want) <= _bf16_ulp(want))
    assert not got[1].any() and not want[1].any()


def test_conv3x3_int8_nan_sample_comes_out_nan_as_in_jax():
    """A NaN anywhere in a sample makes that sample's scale, and so its
    whole output, NaN in both packages: it is not quantized away into a
    finite answer. The other samples are untouched."""
    x, w, _ = _conv_case(48, 40, 12, seed=6, n=3)
    clean = k3.conv3x3_int8(torch.from_numpy(x), torch.from_numpy(w), 1)
    x[1, 7, 3, 5] = np.nan
    got = k3.conv3x3_int8(torch.from_numpy(x), torch.from_numpy(w), 1)
    want = np.asarray(jk3.conv3x3_int8(jnp.asarray(x), jnp.asarray(w), padding=1,
                                       interpret=True), np.float32)
    assert bool(torch.isnan(got[1]).all()) and np.isnan(want[1]).all()
    assert torch.equal(got[[0, 2]], clean[[0, 2]])
    assert np.isfinite(want[[0, 2]]).all()
    _, x_scale = k3.quantize_pack_activations_plain(torch.from_numpy(x), 1)
    assert torch.isnan(x_scale).tolist() == [False, True, False]


def test_quantizers_match_jax_integers():
    """Per-sample and per-channel scales and the rounded integers equal the
    JAX package's exactly (same divide, round half to even, clip)."""
    x, w, _ = _conv_case(48, 40, 20, seed=3)
    x[0] = np.clip(x[0] * 10, -100, 100)
    x[0, 0, 0, :5] = [0.5, 1.5, 2.5, -0.5, 127.0]     # scale 1: these are ties
    xq, xs = k3.quantize_activations(torch.from_numpy(x))
    wq, ws = k3.quantize_weights(torch.from_numpy(w))
    xf = jnp.asarray(x)
    j_xs = jnp.maximum(jnp.max(jnp.abs(xf), axis=(1, 2, 3)), 1e-8) / 127.0
    j_xq = jnp.clip(jnp.round(xf / j_xs[:, None, None, None]), -127, 127)
    wf = jnp.asarray(w)
    j_ws = jnp.maximum(jnp.max(jnp.abs(wf), axis=(1, 2, 3)), 1e-12) / 127.0
    j_wq = jnp.clip(jnp.round(wf / j_ws[:, None, None, None]), -127, 127)
    np.testing.assert_array_equal(xs.numpy(), np.asarray(j_xs))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(j_xq))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(j_ws))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(j_wq))
    assert xq[0, 0, 0, :4].tolist() == [0.0, 2.0, 2.0, -0.0]


@pytest.mark.parametrize("i,o,h,p", [(48, 40, 20, 1), (91, 130, 12, 2),
                                     (64, 64, 9, 0)])
def test_packed_layout_computes_the_same_conv(i, o, h, p):
    """The kernel's operands (int8 NHWC with a zero halo and channels padded
    to 32; weights in blocks [O'/64, I'/32, 9, 2, 64, 16], one per 64 output
    and 32 input channels, [9, O', I'] tap-major once the tiling is undone)
    hold the conv the plain version computes: unpacked and convolved without
    padding they give the same integers exactly."""
    x, w, _ = _conv_case(i, o, h, seed=1)
    xq, _ = k3.quantize_activations(torch.from_numpy(x))
    wq, _ = k3.quantize_weights(torch.from_numpy(w))
    xp, wp = k3.pack_activations(xq, p), k3.pack_weights(wq)
    ip, op = -(-i // 32) * 32, -(-o // 128) * 128
    assert xp.dtype == wp.dtype == torch.int8
    assert xp.shape == (2, h + 2 * p, h + 2 * p, ip) and xp.is_contiguous()
    assert wp.shape == (op // 64, ip // 32, 9, 2, 64, 16) and wp.is_contiguous()
    # a block holds [tap][K chunk of 16][output channel][input channel]
    if o > 66:
        assert int(wp[1, 0, 4, 1, 2, 3]) == int(wq[66, 19, 1, 1])
    wp = k3.unpack_weights(wp)
    assert wp.shape == (9, op, ip)
    assert int(xp[..., i:].abs().sum()) == 0
    assert int(wp[:, o:].abs().sum()) == 0 and int(wp[:, :, i:].abs().sum()) == 0
    taps = wp.reshape(3, 3, op, ip).permute(2, 3, 0, 1)
    got = F.conv2d(xp.permute(0, 3, 1, 2).double(), taps.double())[:, :o]
    want = F.conv2d(xq.double(), wq.double(), padding=p)
    assert torch.equal(got, want)


# (b) ---------------------------------------------------------------------

def _conv3x3_shapes(gen_kwargs, batch):
    """(x_shape, w_shape, padding) of every 3x3 conv of a generator, from
    the JAX package's layout: encoder and decoder layers (full padding 2
    on in_size + ... = the layer's input), and the bottleneck conv."""
    sk = dict(gen_kwargs["synthesis_kwargs"])
    layout = jax_layout(
        gen_kwargs["img_resolution"], gen_kwargs["img_channels_in"],
        gen_kwargs["img_channels_out"], sk.get("channel_base", 32768),
        sk.get("channel_max", 512), sk["num_layers"], sk["num_critical"],
        sk.get("first_cutoff", 2.0), sk.get("first_stopband", 2 ** 2.1),
        sk.get("last_stopband_rel", 2 ** 0.3), sk["margin_size"],
        sk.get("output_scale", 0.25), sk["skip_resolution"])
    shapes = []
    for spec in list(layout.encoder_specs) + list(layout.decoder_specs):
        if spec.is_torgb:
            continue
        shapes.append(((batch, spec.in_channels, spec.in_size, spec.in_size),
                       (spec.out_channels, spec.in_channels, 3, 3), 2))
    c = layout.bottleneck_channels
    size = layout.encoder_specs[-1].out_size
    shapes.append(((batch, c, size + 2, size + 2), (c, c, 3, 3), 0))
    return shapes


ROUTING_CASES = [        # tests/test_conv_int8.py:63-70
    ((1, 64, 32, 32), (64, 64, 1, 1), 1), ((1, 16, 32, 32), (16, 16, 3, 3), 1),
    ((1, 64, 32, 16), (64, 64, 3, 3), 1), ((1, 64, 32, 32), (64, 64, 3, 3), 3),
    ((1, 64, 32, 32), (64, 64, 3, 3), 1), ((16, 362, 148, 148), (512, 362, 3, 3), 2),
    ((1, 64, 5, 5), (64, 64, 3, 3), 0), ((1, 64, 8, 8), (64, 64, 3, 3), 0),
    ((1, 64, 32, 32), (64, 64, 3, 3), (1, 1)), ((1, 64, 32, 32), (64, 64, 3), 1),
]


def test_routing_functions_equal_jax():
    """int8_supported, int8_routable and the gate of mode 'int8' answer as
    the JAX package's do, for the routing cases of its own test and for
    every 3x3 conv of the shipped and the tiny generator at batch 16: the
    TPU memory plan that the port leaves out declines none of them."""
    full = dict(CMSR_ADNI_G)
    full.pop("netG", None)
    cases = list(ROUTING_CASES) + _conv3x3_shapes(full, 16) + _conv3x3_shapes(TINY, 16)
    assert len(cases) >= len(ROUTING_CASES) + 28 + 12
    routed = 0
    for xs, ws, p in cases:
        assert k3.int8_supported(xs, ws) == jk3.int8_supported(xs, ws), (xs, ws)
        for variant in ("dots", "im2col"):
            assert k3.int8_routable(xs, ws, p) == \
                jk3.int8_routable(xs, ws, p, variant), (xs, ws, p, variant)
        routed += k3.int8_routable(xs, ws, p)
        if len(ws) == 4:
            assert tmc._int8_gate(xs, ws) == jmc._int8_gate(xs, ws)
    assert routed > 30


def test_gate_takes_eleven_convs_of_the_shipped_generator():
    """Mode 'int8' on the shipped generator: 10 layers of 512 -> 512 at 36^2
    and 52^2 and the bottleneck conv (38^2, no padding) pass the gate; mode
    'int8_all' takes all 27 layers and the bottleneck conv."""
    full = dict(CMSR_ADNI_G)
    full.pop("netG", None)
    taken = [(xs, ws, p) for xs, ws, p in _conv3x3_shapes(full, 16)
             if k3.int8_routable(xs, ws, p) and tmc._int8_gate(xs, ws)
             and min(ws[0], ws[1]) >= 64]
    assert len(taken) == 11
    assert sorted({(xs[2], p) for xs, _, p in taken}) == [(36, 2), (38, 0), (52, 2)]
    assert all(ws[:2] == (512, 512) for _, ws, _ in taken)
    eligible = [c for c in _conv3x3_shapes(full, 16) if k3.int8_routable(*c)]
    assert len(eligible) == 28      # 27 layers and the bottleneck conv


# (c) ---------------------------------------------------------------------

def test_conv2d_honours_set_conv_impl(int8_mode):
    """ops.conv2d routes by set_conv_impl, equals the JAX package's routed
    result within 1 bf16 ulp (cast back to x.dtype), and grouped or
    asymmetric-padding convs take the float conv in every mode
    (tests/test_conv_int8.py:85-107)."""
    x, w, _ = _conv_case(64, 64, 24, seed=2, n=1)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    float_out = tmc.conv2d(xt, wt, padding=2)
    assert tmc.get_conv_impl() == "xla"
    torch.testing.assert_close(float_out, F.conv2d(xt, wt, padding=2))
    int8_mode("int8")                   # 64 channels: the gate declines
    assert torch.equal(tmc.conv2d(xt, wt, padding=2), float_out)
    int8_mode("int8_all")
    got = tmc.conv2d(xt, wt, padding=2)
    want = np.asarray(jmc.conv2d(jnp.asarray(x), jnp.asarray(w), padding=2))
    assert got.dtype == torch.float32 and got.shape == float_out.shape
    assert np.all(np.abs(got.numpy() - want) <= _bf16_ulp(want))
    assert not torch.equal(got, float_out)
    assert _psnr(got.numpy(), float_out.numpy()) > 50
    # the result is bf16-valued: the kernel's output cast back
    assert torch.equal(got, got.bfloat16().float())
    int8_mode("int8_all", min_ch=128)   # below the channel floor
    assert torch.equal(tmc.conv2d(xt, wt, padding=2), float_out)
    int8_mode("int8_all")
    xg, wg, _ = _conv_case(64, 32, 12, seed=4, n=1)
    wg = np.concatenate([wg, wg], axis=0)[:64, :32]          # [64, 32, 3, 3]
    grouped = tmc.conv2d(torch.from_numpy(xg), torch.from_numpy(wg), padding=1,
                         groups=2)
    torch.testing.assert_close(grouped, F.conv2d(
        torch.from_numpy(xg), torch.from_numpy(wg), padding=1, groups=2))
    asym = tmc.conv2d(xt, wt, padding=(2, 1))
    torch.testing.assert_close(asym, F.conv2d(xt, wt, padding=(2, 1)))
    with pytest.raises(ValueError):
        tmc.set_conv_impl("int4")
    with pytest.raises(ValueError):
        tmc.set_conv_impl("int8", variant="rows")
    with pytest.raises(ValueError, match="int8_routable"):
        k3.conv3x3_int8(xt[:, :16], wt[:16, :16], padding=2)


# (d) ---------------------------------------------------------------------

def test_ste_gradients_match_jax(int8_mode):
    """K4: dx and dw of a loss through the int8 route equal jax.grad through
    the JAX int8 route within 1e-4 of max|grad|: the backward is the same
    exact fp32 conv adjoint, but it is fed cos(y) of forwards that may
    differ by 1 bf16 ulp (4e-3 relative) at a few elements. Against the
    float route they agree to > 30 dB (tests/test_conv_int8.py:139-159)."""
    x, w, _ = _conv_case(48, 48, 16, seed=5, n=1)

    def jax_loss(x, w):
        return jnp.sum(jnp.sin(jmc.conv2d(x, w, padding=1).astype(jnp.float32)))

    def torch_grads():
        xt = torch.from_numpy(x).requires_grad_(True)
        wt = torch.from_numpy(w).requires_grad_(True)
        torch.sin(tmc.conv2d(xt, wt, padding=1).float()).sum().backward()
        return xt.grad.numpy(), wt.grad.numpy()

    gx_float, gw_float = torch_grads()
    int8_mode("int8_all", min_ch=32)
    want_gx, want_gw = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    gx, gw = torch_grads()
    for got, want in ((gx, np.asarray(want_gx)), (gw, np.asarray(want_gw))):
        assert got.shape == want.shape and got.dtype == np.float32
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert _psnr(gx, gx_float) > 30 and _psnr(gw, gw_float) > 30
    assert not np.array_equal(gx, gx_float)


def test_ste_backward_is_the_fp32_conv_adjoint():
    """The backward ignores the quantization: for a linear loss it is
    exactly the float conv's, in the input's dtype."""
    x, w, _ = _conv_case(48, 40, 12, seed=6)
    # bf16-valued: the kernel's output is bf16, so its gradient arrives in bf16
    g = torch.from_numpy(np.random.RandomState(7).randn(2, 40, 14, 14)
                         .astype(np.float32)).bfloat16().float().numpy()

    def grads(fn, dtype):
        xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
        wt = torch.from_numpy(w).requires_grad_(True)
        (fn(xt, wt).float() * torch.from_numpy(g)).sum().backward()
        return xt.grad, wt.grad

    for dtype in (torch.float32, torch.bfloat16):
        dx, dw = grads(lambda a, b: k3.conv3x3_int8_ste(a, b, 2), dtype)
        want_dx, want_dw = grads(lambda a, b: F.conv2d(a.float(), b, padding=2), dtype)
        assert dx.dtype == dtype and dw.dtype == torch.float32
        torch.testing.assert_close(dx, want_dx, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(dw, want_dw, rtol=1e-5, atol=1e-4)


# (e) ---------------------------------------------------------------------

def _spy(module, monkeypatch):
    """Record every decision of a package's _try_conv_int8."""
    calls = []
    original = module._try_conv_int8

    def wrapped(x, w, padding):
        y = original(x, w, padding)
        calls.append((tuple(x.shape), tuple(w.shape), y is not None))
        return y
    monkeypatch.setattr(module, "_try_conv_int8", wrapped)
    return calls


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.RandomState(0)
    z = rng.randn(1, 64).astype(np.float32)
    c = rng.rand(1, 1).astype(np.float32)
    cond = rng.randn(1, 4, 64, 64).clip(-1, 1).astype(np.float32)
    jgen = JaxGenerator(**TINY)
    variables = jax.tree.map(np.asarray, jgen.init(jax.random.PRNGKey(0), z, c, cond))
    port = load_jax_variables(Stylegan3Generator(**TINY), variables)
    return jgen, variables, port, (z, c, cond)


def _port_forward(port, inputs):
    with torch.no_grad():
        return port(*(torch.from_numpy(a) for a in inputs)).numpy()


@pytest.mark.parametrize("mode,routed", [("int8", 0), ("int8_all", 12)])
def test_tiny_generator_int8_matches_jax(tiny, int8_mode, monkeypatch, mode, routed):
    """The tiny generator under the int8 modes, channel floor 32: both
    packages route the same convs (the gate of 'int8' takes none of its
    128-channel convs, 'int8_all' 12 of 14); the outputs agree at rtol 5e-3
    / atol 2e-4 of the output range's scale, the generator contract of
    docs/porting.md:30-32 widened by atol 8e-3 (1% of the 0.82 output
    range) under 'int8_all': a pre-rounding difference of 1e-7 flips single
    quantization steps (1/127 of a layer's range), observed max |diff|
    5.9e-3; and the port's int8 output is >= 45 dB from its float output,
    the guardrail of tests/test_conv_int8.py:110-136."""
    jgen, variables, port, inputs = tiny
    float_out = _port_forward(port, inputs)
    jax_calls, port_calls = _spy(jmc, monkeypatch), _spy(tmc, monkeypatch)
    int8_mode(mode, min_ch=32)
    want = np.asarray(jgen.apply(variables, *inputs), np.float32)
    got = _port_forward(port, inputs)
    assert len(jax_calls) == len(port_calls) == 14
    assert [c[2] for c in port_calls] == [c[2] for c in jax_calls]
    assert [c[:2] for c in port_calls] == [c[:2] for c in jax_calls]
    assert sum(c[2] for c in port_calls) == routed
    atol = 2e-4 if routed == 0 else 8e-3
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=atol)
    assert _psnr(got, float_out) > 45
    if routed:
        assert _psnr(got, want) > 45 and not np.array_equal(got, float_out)
    else:
        np.testing.assert_array_equal(got, float_out)


# (f) ---------------------------------------------------------------------

def test_evaluate_cli_int8(tmp_path):
    """python -m afcm_tpu_torch.evaluate --device cpu ... tpu.conv_int8 True
    on the tiny demo config: sets the conv implementation from the config
    (mode 'int8', floor and variant as given), serves and scores the test
    subject, and leaves the implementation at 'xla'."""
    pytest.importorskip("h5py")
    from afcm_tpu_torch.config import default_argument_parser
    from afcm_tpu_torch.data.demo import write_demo_tree
    from afcm_tpu_torch import evaluate

    write_demo_tree(str(tmp_path / "data"), n_train=0, n_val=0, n_test=1,
                    depth=8, size=64)
    argv = ["--config-file", os.path.join(REPO, "configs/demo/cmsr_tiny.yml"),
            "loaders.test.file_paths", f"['{tmp_path}/data/test']",
            "checkpoints_dir", str(tmp_path / "checkpoints"),
            "tpu.conv_int8", "True", "tpu.conv_int8_variant", "im2col",
            "tpu.conv_int8_min_ch", "32"]
    cfg = default_argument_parser(argv)
    model = build_eval_model(dict(cfg.model.G),
                             generator=torch.Generator().manual_seed(0))
    run_dir = tmp_path / "checkpoints" / "demo_tiny"
    run_dir.mkdir(parents=True)
    torch.save(model.generator_ema.state_dict(), run_dir / "latest_net_G_ema.pth")

    seen = []
    original = evaluate.serve_and_score

    def recording(*args, **kwargs):
        seen.append((tmc.get_conv_impl(), tmc._CONV_INT8_MIN_CH))
        return original(*args, **kwargs)
    evaluate.serve_and_score = recording
    try:
        result = evaluate.main(["--device", "cpu"] + argv)
    finally:
        evaluate.serve_and_score = original
    assert seen == [("int8", 32)]
    assert tmc.get_conv_impl() == "xla"
    assert np.isfinite(result["psnr"]) and np.isfinite(result["ssim"])
    text = (run_dir / "evaluate" / "evaluate.txt").read_text()
    assert "subject:subject_test_0" in text and "^^^VALIDATION" in text
    tmc.set_conv_impl("xla", min_ch=64)


def test_configure_numerics_sets_and_resets_the_conv_impl():
    from afcm_tpu_torch.config import get_default_cfg
    from afcm_tpu_torch.evaluate import configure_numerics
    cfg = get_default_cfg()
    try:
        cfg.tpu.conv_int8 = True
        assert configure_numerics(cfg) == "float32"
        assert tmc.get_conv_impl() == "int8" and tmc._CONV_INT8_MIN_CH == 64
        cfg.tpu.conv_int8 = False
        configure_numerics(cfg)
        assert tmc.get_conv_impl() == "xla"
        cfg.tpu.conv_int8 = True
        cfg.tpu.fetch_dtype = "bfloat16"        # goes with the int8 path
        assert configure_numerics(cfg) == "float32"
        assert tmc.get_conv_impl() == "int8"
        cfg.tpu.fetch_dtype = "float16"         # no such fetch: raises first
        with pytest.raises(ValueError, match="fetch_dtype"):
            configure_numerics(cfg)
    finally:
        tmc.set_conv_impl("xla", min_ch=64)
