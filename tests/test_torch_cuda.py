"""Kernels K1 and K2 on the card: the CUDA filtered_lrelu forward and
backward against their plain versions.

Marked ``cuda``; every test skips without a CUDA device (the CPU tests hold
the plain version against the JAX package in tests/test_torch_ops.py at
small sizes). At the generator's full-size layer shapes the kernel is also
held against the JAX package's own composition,
``afcm_tpu.ops.filtered_lrelu(impl="xla")`` on JAX's CPU backend; those
tests skip where jax is not installed.
Run on the GPU machine with ``python -m pytest tests/test_torch_cuda.py``.
Tolerances: fp32 atol/rtol 1e-4 (tests/test_pallas_mxu.py:56-57), with TF32
off; bf16 PSNR >= 38 dB against the fp32 plain version (:104-126). K2's
fp32 gradients are held at the same 1e-4, scaled by the largest gradient
at the full-size shapes, where a 24-tap filter sums many terms. The last
test holds ``ops.conv2d_gradfix`` (the discriminator's convs under R1) to
F.conv2d's own autograd on cuDNN at the same 1e-4.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from afcm_tpu_torch.evaluate import set_matmul_precision  # noqa: E402
from afcm_tpu_torch.models import CMSR_ADNI_G, build_generator  # noqa: E402
from afcm_tpu_torch.ops import design_lowpass_filter, filtered_lrelu  # noqa: E402
from afcm_tpu_torch.ops.cuda import filtered_lrelu as k1  # noqa: E402

pytestmark = pytest.mark.cuda

# The shipped generator's variants at small C and sizes, plus the corners
# the kernel must also take: odd and non-square sizes, no bias, no clamp,
# flip_filter, up = down = 1 with filters, up 3, identity filters.
CASES = {
    "A_u2d2": dict(h=38, w=38, c=3, up=2, down=2, ntu=12, ntd=12,
                   pad=(9, 8, 9, 8)),
    "B_u2d4": dict(h=54, w=54, c=2, up=2, down=4, ntu=12, ntd=24,
                   pad=(34, 33, 34, 33)),
    "C_u4d2": dict(h=38, w=38, c=2, up=4, down=2, ntu=24, ntd=12,
                   pad=(-6, -9, -6, -9)),
    "D_crop": dict(h=70, w=70, c=2, up=2, down=2, ntu=12, ntd=12,
                   pad=(-11, -12, -11, -12)),
    "odd_nonsquare_nobias": dict(h=29, w=41, c=5, up=2, down=2, ntu=12,
                                 ntd=12, pad=(3, 7, 5, 1), bias=False),
    "flip_noclamp": dict(h=33, w=33, c=2, up=2, down=4, ntu=12, ntd=24,
                         pad=(10, 11, 12, 9), flip=True, clamp=None),
    "u1d1_filtered": dict(h=21, w=21, c=2, up=1, down=1, ntu=7, ntd=5,
                          pad=(4, 2, 3, 3)),
    "u3d2": dict(h=17, w=19, c=2, up=3, down=2, ntu=18, ntd=12,
                 pad=(5, 6, -2, 4)),
    "identity_filters_u2": dict(h=16, w=16, c=2, up=2, down=1, ntu=None,
                                ntd=None, pad=(0, 0, 0, 0)),
}

# One layer of the shipped generator per variant, as in chip_smoke.py:
# (encoder or decoder, index).
FULL_SIZE = {"A_L12_276_64": ("decoder", 12), "B_encoder_4": ("encoder", 4),
             "C_L10_276_128": ("decoder", 10), "D_L13_256_64": ("decoder", 13)}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    set_matmul_precision("float32")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def jax_ops(cuda):
    """jax and afcm_tpu.ops (which imports jax but not flax). JAX must not
    take the card's memory from torch."""
    os.environ.setdefault("XLA_PYTHON_CLIENT_PREALLOCATE", "false")
    return pytest.importorskip("jax"), pytest.importorskip("afcm_tpu.ops")


@pytest.fixture(scope="module")
def shipped_synthesis(cuda):
    return build_generator(CMSR_ADNI_G).synthesis


def _case(case, device, seed=0):
    rng = np.random.RandomState(seed)
    fs = case["w"] * case["up"]
    fu = None if case["ntu"] is None else design_lowpass_filter(
        case["ntu"], cutoff=fs / 8, width=fs / 8, fs=fs)
    fd = None if case["ntd"] is None else design_lowpass_filter(
        case["ntd"], cutoff=fs / 8, width=fs / 8, fs=fs)
    x = torch.from_numpy(rng.randn(2, case["c"], case["h"], case["w"])
                         .astype(np.float32)).to(device)
    b = torch.from_numpy(rng.randn(case["c"]).astype(np.float32)).to(device) \
        if case.get("bias", True) else None
    kw = dict(fu=fu, fd=fd, up=case["up"], down=case["down"],
              padding=case["pad"], gain=np.sqrt(2), slope=0.2,
              clamp=case.get("clamp", 256.0),
              flip_filter=case.get("flip", False))
    return x, b, kw


def _psnr(got, want):
    err = float(torch.mean((got.float() - want) ** 2))
    data_range = float(want.max() - want.min())
    return 10 * np.log10(data_range ** 2 / max(err, 1e-12))


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_fp32(cuda, name):
    x, b, kw = _case(CASES[name], cuda)
    want = k1.filtered_lrelu_plain(x, b=b, **kw)
    launches = k1.launches
    got = k1.filtered_lrelu_cuda(x, b=b, **kw)
    torch.cuda.synchronize()
    assert k1.launches == launches + 1
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["A_u2d2", "B_u2d4", "C_u4d2", "D_crop"])
def test_kernel_bf16_psnr(cuda, name):
    x, b, kw = _case(CASES[name], cuda)
    want = k1.filtered_lrelu_plain(x, b=b, **kw)
    got = k1.filtered_lrelu_cuda(x.bfloat16(), b=b.bfloat16(), **kw)
    assert got.dtype == torch.bfloat16
    assert _psnr(got, want) >= 38


def test_dispatch_sends_cuda_tensors_to_the_kernel(cuda):
    x, b, kw = _case(CASES["A_u2d2"], cuda)
    launches = k1.launches
    filtered_lrelu(x, b=b, **kw)
    assert k1.launches == launches + 1
    # toRGB stays elementwise torch on the card too
    filtered_lrelu(x, b=b, up=1, down=1, gain=1, slope=1, clamp=256)
    assert k1.launches == launches + 1


def test_kernel_raises_on_bad_input(cuda):
    x, b, kw = _case(CASES["A_u2d2"], cuda)
    with pytest.raises(ValueError, match="contiguous"):
        k1.filtered_lrelu_cuda(x.transpose(2, 3), b=b, **kw)
    with pytest.raises(ValueError, match="bias"):
        k1.filtered_lrelu_cuda(x, b=b[:1], **kw)
    y = k1.filtered_lrelu_cuda(x, b=b, **kw)
    for fn, args in ((k1.filtered_lrelu_cuda, (x.cpu(),)),
                     (k1.filtered_lrelu_bwd_cuda, (x.cpu(), y.cpu()))):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(*args, b=b.cpu(), **kw)
    with pytest.raises(NotImplementedError, match="separable"):
        k1.filtered_lrelu_bwd_cuda(x, y, b=b, **dict(kw, fd=np.ones((3, 3))))
    with pytest.raises(ValueError, match="taps"):
        k1.filtered_lrelu_bwd_cuda(x, y, b=b, **dict(kw, fu=np.ones(65)))
    with pytest.raises(ValueError, match="dy of shape"):
        k1.filtered_lrelu_bwd_cuda(x, y[:, :, 1:], b=b, **kw)


def _bwd_case(name, device, seed=0):
    x, b, kw = _case(CASES[name], device, seed)
    y = k1.filtered_lrelu_plain(x, b=b, **kw)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    dy = torch.randn(y.shape, generator=gen, device=device)
    return x, b, dy, kw


@pytest.mark.parametrize("name", sorted(CASES))
def test_bwd_kernel_matches_plain_fp32(cuda, name):
    x, b, dy, kw = _bwd_case(name, cuda)
    want_dx, want_db = k1.filtered_lrelu_bwd_plain(x, dy, b=b, **kw)
    launches = k1.bwd_launches
    dx, db = k1.filtered_lrelu_bwd_cuda(x, dy, b=b, **kw)
    torch.cuda.synchronize()
    assert k1.bwd_launches == launches + 1
    assert dx.shape == x.shape and dx.dtype == torch.float32
    np.testing.assert_allclose(dx.cpu().numpy(), want_dx.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)
    if b is None:
        assert db is None
    else:
        np.testing.assert_allclose(db.cpu().numpy(), want_db.cpu().numpy(),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["A_u2d2", "B_u2d4", "C_u4d2", "D_crop"])
def test_bwd_kernel_bf16_psnr(cuda, name):
    x, b, dy, kw = _bwd_case(name, cuda)
    want, _ = k1.filtered_lrelu_bwd_plain(x, dy, b=b, **kw)
    got, _ = k1.filtered_lrelu_bwd_cuda(x.bfloat16(), dy.bfloat16(),
                                        b=b.bfloat16(), **kw)
    assert got.dtype == torch.bfloat16
    assert _psnr(got, want) >= 38


def test_autograd_runs_k2(cuda):
    """Under autograd the dispatch runs K1 forward and K2 backward, never
    the plain backward, and takes a strided output gradient."""
    x, b, dy, kw = _bwd_case("B_u2d4", cuda)
    want_dx, want_db = k1.filtered_lrelu_bwd_plain(x, dy, b=b, **kw)
    xg, bg = x.clone().requires_grad_(), b.clone().requires_grad_()
    fwd, bwd = k1.launches, k1.bwd_launches
    y = filtered_lrelu(xg, b=bg, **kw)
    strided = dy.transpose(2, 3).contiguous().transpose(2, 3)
    assert not strided.is_contiguous()
    dx, db = torch.autograd.grad(y, (xg, bg), strided)
    assert (k1.launches, k1.bwd_launches) == (fwd + 1, bwd + 1)
    np.testing.assert_allclose(dx.cpu().numpy(), want_dx.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(db.cpu().numpy(), want_db.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("variant", sorted(FULL_SIZE))
def test_kernel_matches_jax_full_size(jax_ops, shipped_synthesis, cuda, variant):
    """K1 against afcm_tpu.ops.filtered_lrelu(impl="xla") on the same numpy
    inputs at a full-size layer shape of the shipped generator, batch 2."""
    jax, ops = jax_ops
    side, idx = FULL_SIZE[variant]
    layer = getattr(shipped_synthesis, side + "s")[idx]
    spec = layer.spec
    rng = np.random.RandomState(0)
    size = spec.in_size + 2                     # the 3x3 conv's output
    x = rng.randn(2, spec.out_channels, size, size).astype(np.float32)
    b = rng.randn(spec.out_channels).astype(np.float32)
    kw = dict(fu=layer.up_filter, fd=layer.down_filter, up=layer.up,
              down=layer.down, padding=layer.padding, gain=float(np.sqrt(2)),
              slope=0.2, clamp=layer.conv_clamp)
    with jax.default_device(jax.devices("cpu")[0]), \
            jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda x, b: ops.filtered_lrelu(
            x, b=b, impl="xla", **kw))(x, b))
    got = k1.filtered_lrelu_cuda(torch.from_numpy(x).to(cuda),
                                 b=torch.from_numpy(b).to(cuda), **kw)
    out = (2, spec.out_channels, spec.out_size, spec.out_size)
    assert tuple(got.shape) == want.shape == out
    got = got.cpu().numpy()
    print(f"{variant}: max|diff| {np.abs(got - want).max():.3g}, "
          f"max|ref| {np.abs(want).max():.3g}")        # shown by pytest -rP
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("variant", sorted(FULL_SIZE))
def test_bwd_kernel_matches_jax_full_size(jax_ops, shipped_synthesis, cuda,
                                          variant):
    """K2 against jax.vjp of afcm_tpu.ops.filtered_lrelu(impl="xla") on the
    same numpy inputs at a full-size layer shape, batch 2."""
    jax, ops = jax_ops
    side, idx = FULL_SIZE[variant]
    layer = getattr(shipped_synthesis, side + "s")[idx]
    spec = layer.spec
    rng = np.random.RandomState(1)
    size = spec.in_size + 2
    x = rng.randn(2, spec.out_channels, size, size).astype(np.float32)
    b = rng.randn(spec.out_channels).astype(np.float32)
    dy = rng.randn(2, spec.out_channels, spec.out_size,
                   spec.out_size).astype(np.float32)
    kw = dict(fu=layer.up_filter, fd=layer.down_filter, up=layer.up,
              down=layer.down, padding=layer.padding, gain=float(np.sqrt(2)),
              slope=0.2, clamp=layer.conv_clamp)
    with jax.default_device(jax.devices("cpu")[0]), \
            jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(lambda x, b: ops.filtered_lrelu(
            x, b=b, impl="xla", **kw), x, b)
        want_dx, want_db = (np.asarray(g) for g in jax.jit(vjp)(dy))
    dx, db = k1.filtered_lrelu_bwd_cuda(
        torch.from_numpy(x).to(cuda), torch.from_numpy(dy).to(cuda),
        b=torch.from_numpy(b).to(cuda), **kw)
    # Where the pre-activation is within rounding of the kink, JAX's and the
    # kernel's slopes may differ (slope_ambiguous); those pixels are counted
    # and their dx, and their share of db, taken from the kernel.
    ok = ~k1.slope_ambiguous(torch.from_numpy(x).to(cuda),
                             b=torch.from_numpy(b).to(cuda), **{
                                 k: v for k, v in kw.items()
                                 if k not in ("fd", "down")}).cpu().numpy()
    dx, db = dx.cpu().numpy(), db.cpu().numpy()
    want_db = want_db + np.where(ok, 0, dx - want_dx).sum((0, 2, 3))
    print(f"{variant}: dx max|diff| {np.abs(dx - want_dx)[ok].max():.3g} "
          f"(all: {np.abs(dx - want_dx).max():.3g}, {int((~ok).sum())} pixels "
          f"at the kink), max|ref| {np.abs(want_dx).max():.3g}; db max|diff| "
          f"{np.abs(db - want_db).max():.3g}, max|ref| {np.abs(want_db).max():.3g}")
    assert ok.mean() > 0.95
    np.testing.assert_allclose(dx[ok], want_dx[ok], rtol=1e-4,
                               atol=1e-4 * np.abs(want_dx).max())
    np.testing.assert_allclose(db, want_db, rtol=1e-4,
                               atol=1e-4 * np.abs(want_db).max())


@pytest.mark.parametrize("groups,stride,kernel", [
    (1, 1, (3, 3)),          # D's conv0
    (1, 2, (3, 3)),          # D's conv1 after its FIR
    (64, 2, (1, 4)),         # a FIR pass of D's resampling, constant taps
])
def test_conv2d_gradfix_matches_autograd(cuda, groups, stride, kernel):
    """ops.conv2d_gradfix on cuDNN against F.conv2d's own autograd, fp32
    with TF32 off, at a discriminator-sized conv: the value, R1's input
    gradient and its second-order gradients w.r.t. x and the weight."""
    from afcm_tpu_torch.ops import conv2d_gradfix
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((4, 64, 128, 128), generator=gen, device=cuda)
    w = torch.randn((64, 64 // groups, *kernel), generator=gen, device=cuda)
    x.requires_grad_(True)
    inputs = (x, w.requires_grad_(True)) if groups == 1 else (x,)
    padding = (kernel[0] // 2, kernel[1] // 2) if stride == 1 else (0, 0)
    results = []
    for conv in (torch.nn.functional.conv2d, conv2d_gradfix.conv2d):
        y = conv(x, w, stride=stride, padding=padding, groups=groups)
        (dx,) = torch.autograd.grad(torch.tanh(y).sum(), x, create_graph=True)
        results.append((y, dx, *torch.autograd.grad(dx.square().sum(), inputs)))
    for got, want in zip(results[1], results[0]):
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)
