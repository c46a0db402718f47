"""The hand-written kernels on the card: the CUDA filtered_lrelu forward
and backward (K1, K2), the int8 conv (K3, K4) with its quantizer kernels and
the probe kernels (K5-K9) against their plain versions.

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
    # sizes that are no multiple of K2's tile, several tiles per axis: each
    # specialised geometry (A, B, C) and the generic kernel
    "A_ragged_tiles": dict(h=61, w=83, c=2, up=2, down=2, ntu=12, ntd=12,
                           pad=(9, 8, 9, 8)),
    "B_ragged_tiles_flip": dict(h=70, w=59, c=2, up=2, down=4, ntu=12, ntd=24,
                                pad=(34, 33, 34, 33), flip=True),
    "C_ragged_tiles_noclamp_nobias": dict(h=45, w=51, c=2, up=4, down=2, ntu=24,
                                          ntd=12, pad=(-6, -9, -6, -9),
                                          clamp=None, bias=False),
    "D_ragged_tiles_odd_pad": dict(h=67, w=49, c=2, up=2, down=2, ntu=12, ntd=12,
                                   pad=(-11, -12, -10, -13)),
    "generic_ragged_tiles_u3d2": dict(h=41, w=37, c=2, up=3, down=2, ntu=18,
                                      ntd=12, pad=(5, 6, -2, 4), flip=True),
    # several K1 tiles per axis for the generic kernel too
    "generic_fwd_ragged_tiles_u3d2": dict(h=61, w=53, c=2, up=3, down=2, ntu=18,
                                          ntd=12, pad=(5, 6, -2, 4)),
}
# K2's instantiation per case: the specialised kernel of the geometry, or
# the generic one.
SPECIALISED = {name for name, case in CASES.items()
               if (case["up"], case["down"], case["ntu"], case["ntd"])
               in k1.BWD_SPECIALISED}
# K1's, by the same rule.
FWD_SPECIALISED = {name for name, case in CASES.items()
                   if (case["up"], case["down"], case["ntu"], case["ntd"])
                   in k1.FWD_SPECIALISED}

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


def _fwd_plan(case):
    """K1's plan for a case, from its shapes alone (no device needed)."""
    x, _, kw = _case(case, "cpu")
    plan = k1._Plan(x, kw["fu"], kw["fd"], kw["up"], kw["down"], kw["padding"],
                    kw["gain"], kw["slope"], kw["clamp"], kw["flip_filter"])
    return plan, k1.plan_fwd_tile(plan.up, plan.down, len(plan.gu), len(plan.gd),
                                  plan.out_h, plan.out_w)


def test_fwd_cases_cover_every_instantiation():
    """The cases reach each of K1's specialised instantiations at a single
    tile and at ragged tiles (several per image, the last cut by the
    image's edge), and the generic kernel at both."""
    single, ragged = set(), set()
    for name, c in CASES.items():
        plan, tile = _fwd_plan(c)
        key = (c["up"], c["down"], c["ntu"], c["ntd"]) if tile["specialised"] else "generic"
        assert tile["specialised"] == (name in FWD_SPECIALISED)
        if tile["tiles"] == 1:
            single.add(key)
        elif plan.out_h % tile["tile_y"] or plan.out_w % tile["tile_x"]:
            ragged.add(key)
    want = set(k1.FWD_SPECIALISED) | {"generic"}
    assert single == want and ragged == want


@pytest.mark.parametrize("name", sorted(FWD_SPECIALISED))
def test_fwd_specialised_and_generic_kernels_agree(cuda, monkeypatch, name):
    """K1's specialised instantiation and its generic kernel on the same
    inputs: the same FMAs in the same order (taps ascending from the
    polyphase start, W then H up, H then W down), so they should be equal
    bit for bit; held to 1e-5 of the largest output + 1e-6, and the count of
    unequal elements is printed (pytest -rP)."""
    x, b, kw = _case(CASES[name], cuda, seed=2)
    spec = k1.filtered_lrelu_cuda(x, b=b, **kw)
    monkeypatch.setattr(k1, "FWD_SPECIALISED", frozenset())
    plan = k1._Plan(x, kw["fu"], kw["fd"], kw["up"], kw["down"], kw["padding"],
                    kw["gain"], kw["slope"], kw["clamp"], kw["flip_filter"])
    assert plan.fwd_tile()[-1] == 0
    generic = k1.filtered_lrelu_cuda(x, b=b, **kw)
    torch.cuda.synchronize()
    unequal = int((spec != generic).sum())
    print(f"{name}: {unequal} of {generic.numel()} elements unequal, max|diff| "
          f"{float((spec - generic).abs().max()):.3g}")
    bound = 1e-5 * float(generic.abs().max()) + 1e-6
    assert float((spec - generic).abs().max()) <= bound


def test_fwd_rejects_a_plan_its_kernel_does_not_take(cuda, monkeypatch):
    """A geometry without an instantiation that asks for one, or a plan
    whose windows are not the kernel's, is refused by K1's entry point: no
    instantiation stands in for another."""
    x, b, kw = _case(CASES["u3d2"], cuda)
    k1._kernel("fwd")       # loaded, and its list of instantiations checked, before the patch
    monkeypatch.setattr(k1, "FWD_SPECIALISED", frozenset({(3, 2, 18, 12)}))
    with pytest.raises(RuntimeError, match="CUDA error"):
        k1.filtered_lrelu_cuda(x, b=b, **kw)
    monkeypatch.undo()
    x, b, kw = _case(CASES["A_u2d2"], cuda)
    real = k1.plan_fwd_tile
    for field in ("in_x", "mid_y", "smem_bytes"):
        monkeypatch.setattr(k1, "plan_fwd_tile",
                            lambda *a, field=field: dict(real(*a), **{field: real(*a)[field] + 4}))
        with pytest.raises(RuntimeError, match="CUDA error"):
            k1.filtered_lrelu_cuda(x, b=b, **kw)


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


@pytest.mark.parametrize("name", ["A_ragged_tiles", "B_ragged_tiles_flip",
                                  "C_ragged_tiles_noclamp_nobias",
                                  "D_ragged_tiles_odd_pad"])
def test_bwd_ragged_bf16_psnr(cuda, name):
    x, b, dy, kw = _bwd_case(name, cuda)
    want, _ = k1.filtered_lrelu_bwd_plain(x, dy, b=b, **kw)
    got, _ = k1.filtered_lrelu_bwd_cuda(
        x.bfloat16(), dy.bfloat16(), b=None if b is None else b.bfloat16(), **kw)
    assert got.dtype == torch.bfloat16
    assert _psnr(got, want) >= 38


def test_bwd_cases_cover_every_instantiation():
    """The cases above reach each specialised instantiation at a single tile
    and at ragged tiles, and the generic kernel."""
    geometries = {(c["up"], c["down"], c["ntu"], c["ntd"])
                  for name, c in CASES.items() if name in SPECIALISED}
    assert geometries == set(k1.BWD_SPECIALISED)
    assert {"u3d2", "u1d1_filtered", "identity_filters_u2",
            "generic_ragged_tiles_u3d2"} <= set(CASES) - SPECIALISED
    for name in ("A_ragged_tiles", "B_ragged_tiles_flip", "C_ragged_tiles_noclamp_nobias",
                 "D_ragged_tiles_odd_pad", "generic_ragged_tiles_u3d2"):
        c = CASES[name]
        plan = k1.plan_bwd_tile(c["up"], c["down"], c["ntu"], c["ntd"], c["h"], c["w"])
        assert plan["tiles"] > 1 and (c["h"] % plan["tile"] or c["w"] % plan["tile"])


@pytest.mark.parametrize("name", sorted(SPECIALISED))
def test_bwd_specialised_and_generic_kernels_agree(cuda, monkeypatch, name):
    """The specialised instantiation and the generic kernel on the same
    inputs: the same function, summed in another order, so 1e-5 of the
    largest gradient apart outside the pixels whose slope rounding decides
    (none at these sizes and seeds, or the bound below fails)."""
    x, b, dy, kw = _bwd_case(name, cuda, seed=2)
    spec, _ = k1.filtered_lrelu_bwd_cuda(x, dy, b=b, **kw)
    monkeypatch.setattr(k1, "BWD_SPECIALISED", frozenset())
    plan = k1._Plan(x, kw["fu"], kw["fd"], kw["up"], kw["down"], kw["padding"],
                    kw["gain"], kw["slope"], kw["clamp"], kw["flip_filter"])
    assert plan.bwd_tile()[-1] == 0
    generic, _ = k1.filtered_lrelu_bwd_cuda(x, dy, b=b, **kw)
    torch.cuda.synchronize()
    bound = 1e-5 * float(generic.abs().max()) + 1e-6
    assert float((spec - generic).abs().max()) <= bound


def test_bwd_rejects_a_plan_its_kernel_does_not_take(cuda, monkeypatch):
    """A geometry without an instantiation that asks for one, or a plan
    whose windows are not the kernel's, is refused by the entry point: no
    instantiation stands in for another."""
    x, b, dy, kw = _bwd_case("u3d2", cuda)
    k1._kernel("bwd")       # loaded, and its list of instantiations checked, before the patch
    monkeypatch.setattr(k1, "BWD_SPECIALISED", frozenset({(3, 2, 18, 12)}))
    with pytest.raises(RuntimeError, match="CUDA error"):
        k1.filtered_lrelu_bwd_cuda(x, dy, b=b, **kw)
    monkeypatch.undo()
    x, b, dy, kw = _bwd_case("A_u2d2", cuda)
    real = k1.plan_bwd_tile
    monkeypatch.setattr(k1, "plan_bwd_tile",
                        lambda *a: dict(real(*a), mid=real(*a)["mid"] + 1))
    with pytest.raises(RuntimeError, match="CUDA error"):
        k1.filtered_lrelu_bwd_cuda(x, dy, b=b, **kw)


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


# --- K3 and K4: the int8 3x3 conv and its straight-through Function ---------

INT8_CASES = {        # (in channels, out channels, size, padding, extra_scale)
    "path_512_36_p2": (512, 512, 36, 2, False),
    "bottleneck_512_38_p0": (512, 512, 38, 0, False),
    "odd_91_181_p1_extra": (91, 181, 40, 1, True),
    "narrow_64_64_ragged_p2": (64, 64, 75, 2, False),
    "path_512_52_p2": (512, 512, 52, 2, False),
    "o96_i40_h9_p0": (40, 96, 9, 0, False),
    "o96_i40_h9_p2_extra": (40, 96, 9, 2, True),
    "o128_i40_h36_p1": (40, 128, 36, 1, False),
    "o160_i512_h38_p1": (512, 160, 38, 1, False),
    "o160_i40_h52_p0_extra": (40, 160, 52, 0, True),
    "o128_i512_h9_p1": (512, 128, 9, 1, False),
}


def _int8_case(name, device, n=2, seed=0):
    i, o, h, p, extra = INT8_CASES[name]
    rng = np.random.RandomState(seed)
    x = rng.randn(n, i, h, h).astype(np.float32)
    w = (rng.randn(o, i, 3, 3) / np.sqrt(9 * i)).astype(np.float32)
    es = (rng.rand(n, o) + 0.5).astype(np.float32) if extra else None
    to = lambda a: None if a is None else torch.from_numpy(a).to(device)  # noqa: E731
    return (x, w, es), (to(x), to(w), to(es)), p


@pytest.mark.parametrize("name", sorted(INT8_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_int8_kernel_equals_plain_bitwise(cuda, name, dtype):
    """Integer accumulation has no rounding: K3 and its plain version give
    the same bf16 bits on the same inputs."""
    from afcm_tpu_torch.ops.cuda import conv_int8 as k3
    _, (x, w, es), p = _int8_case(name, cuda)
    x = x.to(dtype)
    want = k3.conv3x3_int8_plain(x, w, p, es)
    launches = k3.launches
    got = k3.conv3x3_int8(x, w, p, es)
    torch.cuda.synchronize()
    assert k3.launches == launches + 1
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert int((got.view(torch.int16) != want.view(torch.int16)).sum()) == 0
    ref = torch.nn.functional.conv2d(x.float(), w, padding=p)
    if es is not None:
        ref = ref * es[:, :, None, None]
    assert _psnr(got, ref) > (50 if dtype == torch.float32 else 45)


@pytest.mark.parametrize("name", ["path_512_36_p2", "o96_i40_h9_p2_extra",
                                  "o160_i512_h38_p1", "o128_i40_h36_p1"])
@pytest.mark.parametrize("n", [1, 16])
def test_conv_int8_kernel_equals_plain_bitwise_batches(cuda, name, n):
    """K3 alone on packed operands at batch 1 and 16, against the integer
    conv in float64: the same bf16 bits."""
    from afcm_tpu_torch.ops.cuda import conv_int8 as k3
    _, (x, w, es), p = _int8_case(name, cuda, n=n, seed=3)
    xq, x_scale = k3.quantize_activations(x)
    wq, w_scale = k3.quantize_weights(w)
    scale = k3.dequant_scale(x_scale, w_scale, es)
    got = k3.int8_conv_cuda(k3.pack_activations(xq, p), k3.pack_weights(wq), scale,
                            w.shape[0])
    torch.cuda.synchronize()
    want = k3.int8_conv_plain(xq, wq, scale, p)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert int((got.view(torch.int16) != want.view(torch.int16)).sum()) == 0


@pytest.mark.parametrize("name", sorted(INT8_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantizer_kernels_equal_plain_bitwise(cuda, name, dtype):
    """The activation and the weight quantizer kernels against their plain
    versions: the packed int8 tensors and the scales, bit for bit, with an
    all-zero sample (the scale's floor) and rounding ties in the input."""
    from afcm_tpu_torch.ops.cuda import conv_int8 as k3
    _, (x, w, _), p = _int8_case(name, cuda, n=3, seed=4)
    x[1] = 0
    x[2] = (x[2] * 40).round().clamp(-127, 127) / 2        # scale 1/2: halves are ties
    x[2, 0, 0, 0] = 63.5
    w[1] = 0
    x, w = x.to(dtype), w.to(dtype)
    counts = (k3.quantize_launches, k3.weight_quantize_launches)
    xp, x_scale = k3.quantize_pack_activations_cuda(x, p)
    wp, w_scale = k3.quantize_pack_weights_cuda(w)
    torch.cuda.synchronize()
    assert (k3.quantize_launches, k3.weight_quantize_launches) == \
        (counts[0] + 1, counts[1] + 1)
    want_xp, want_xs = k3.quantize_pack_activations_plain(x, p)
    want_wp, want_ws = k3.quantize_pack_weights_plain(w)
    assert xp.dtype == wp.dtype == torch.int8
    assert xp.shape == want_xp.shape and wp.shape == want_wp.shape
    assert int((xp != want_xp).sum()) == 0 and int((wp != want_wp).sum()) == 0
    assert torch.equal(x_scale.view(torch.int32), want_xs.view(torch.int32))
    assert torch.equal(w_scale.view(torch.int32), want_ws.view(torch.int32))
    assert float(x_scale[1]) == float(np.float32(1e-8) / np.float32(127.0))
    assert int(xp[1].abs().sum()) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["path_512_36_p2", "o96_i40_h9_p2_extra"])
def test_quantizer_kernels_propagate_nan(cuda, name, dtype):
    """A NaN in one sample (one output channel of the weights) makes that
    scale NaN, as the plain version's amax does, so the conv's sample
    (channel) comes out NaN; every other sample and channel keeps the plain
    version's bits."""
    from afcm_tpu_torch.ops.cuda import conv_int8 as k3
    _, (x, w, es), p = _int8_case(name, cuda, n=3, seed=5)
    x, w = x.to(dtype), w.to(dtype)
    x[1, 7, 3, 5] = float("nan")
    w[4, 9, 1, 2] = float("nan")
    xp, x_scale = k3.quantize_pack_activations_cuda(x, p)
    wp, w_scale = k3.quantize_pack_weights_cuda(w)
    want_xp, want_xs = k3.quantize_pack_activations_plain(x, p)
    want_wp, want_ws = k3.quantize_pack_weights_plain(w)
    assert torch.isnan(x_scale).tolist() == [False, True, False]
    assert torch.isnan(w_scale).nonzero().flatten().tolist() == [4]
    assert torch.equal(torch.isnan(want_xs), torch.isnan(x_scale))
    assert torch.equal(torch.isnan(want_ws), torch.isnan(w_scale))
    fine = torch.tensor([0, 2], device=cuda)
    assert torch.equal(xp[fine], want_xp[fine])
    assert torch.equal(x_scale[fine].view(torch.int32), want_xs[fine].view(torch.int32))
    keep = torch.arange(w.shape[0], device=cuda) != 4
    got_flat, want_flat = k3.unpack_weights(wp), k3.unpack_weights(want_wp)
    assert torch.equal(got_flat[:, :w.shape[0]][:, keep], want_flat[:, :w.shape[0]][:, keep])
    assert torch.equal(w_scale[keep].view(torch.int32), want_ws[keep].view(torch.int32))
    got = k3.conv3x3_int8(x, w, p, es)
    want = k3.conv3x3_int8_plain(x, w, p, es)
    nan = torch.isnan(got)
    assert bool(nan[1].all()) and bool(nan[:, 4].all())
    assert torch.equal(nan, torch.isnan(want))
    assert torch.equal(got[~nan].view(torch.int16), want[~nan].view(torch.int16))


def test_quantizer_kernels_raise_on_what_they_do_not_take(cuda):
    from afcm_tpu_torch.ops.cuda import conv_int8 as k3
    x = torch.randn(2, 64, 16, 16, device=cuda)
    w = torch.randn(64, 64, 3, 3, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        k3.quantize_pack_activations_cuda(x.transpose(2, 3), 1)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        k3.quantize_pack_activations_cuda(x.half(), 1)
    with pytest.raises(ValueError, match="CUDA"):
        k3.quantize_pack_weights_cuda(w.cpu())
    with pytest.raises(ValueError, match="3x3"):
        k3.quantize_pack_weights_cuda(torch.randn(64, 64, 1, 1, device=cuda))
    with pytest.raises(ValueError, match="padding"):
        k3.quantize_pack_activations_cuda(x, -1)
    # the wrapper copies a strided or float16 tensor instead of refusing it
    got = k3.conv3x3_int8(x.transpose(2, 3).half(), w, 1)
    assert torch.equal(got, k3.conv3x3_int8_plain(x.transpose(2, 3).half(), w, 1))


# The activation quantizer at the edges of its plan, one launch each:
# (n, i, h, p, dtype, elements x lies past a 16-byte boundary).
QUANT_X_CASES = {
    "n64_36_p2_bf16": (64, 512, 36, 2, torch.bfloat16, 0),   # tickets wrap many times
    "view_2_bytes_off_16_bf16": (3, 512, 36, 2, torch.bfloat16, 1),
    "view_2_bytes_off_16_ragged_bf16": (2, 91, 41, 1, torch.bfloat16, 1),
    "i200_p1_bf16": (3, 200, 20, 1, torch.bfloat16, 0),      # I' = 224 > I
    "i200_p2_fp32": (3, 200, 20, 2, torch.float32, 0),
    "38_p0_bf16": (4, 512, 38, 0, torch.bfloat16, 0),        # rows, planes not 16-byte multiples
    "13_p0_fp32": (3, 96, 13, 0, torch.float32, 0),
    "13_p1_fp32": (3, 96, 13, 1, torch.float32, 0),
    "13_p2_fp32": (3, 96, 13, 2, torch.float32, 0),
    "13_p0_bf16": (3, 96, 13, 0, torch.bfloat16, 0),
    "13_p1_bf16": (3, 96, 13, 1, torch.bfloat16, 0),
    "13_p2_bf16": (3, 96, 13, 2, torch.bfloat16, 0),
    "h4_p2_bf16": (2, 40, 4, 2, torch.bfloat16, 0),
}


def _quant_x(cuda, n, i, h, dtype, offset, seed):
    """x [n, i, h, h] from numpy: sample 0 all zero (the scale's floor),
    sample 1 halves with a maximum of 127 (scale 1: rounding ties), as a
    contiguous view ``offset`` elements into a larger tensor."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, i, h, h).astype(np.float32)
    x[0] = 0
    x[1] = (x[1] * 40).round().clip(-250, 250) / 2
    x[1, 0, 0, 0] = 127.0
    base = torch.empty(x.size + offset + 8, dtype=dtype, device=cuda)
    view = base[offset:offset + x.size].view(x.shape)
    view.copy_(torch.from_numpy(x))
    return view


@pytest.mark.parametrize("name", sorted(QUANT_X_CASES))
def test_activation_quantizer_equals_plain_at_its_plan_edges(cuda, name):
    """The activation quantizer kernel bit for bit against its plain
    version (packed tensor and scales) where its plan changes: many tickets
    per CTA, x off a 16-byte boundary (narrower loads), I' > I, planes that
    are no multiple of 16 bytes, p = 0, 1, 2 in both dtypes, H = 4."""
    from afcm_tpu_torch.ops.cuda import conv_int8 as k3
    n, i, h, p, dtype, offset = QUANT_X_CASES[name]
    x = _quant_x(cuda, n, i, h, dtype, offset, seed=n + i + h)
    assert x.is_contiguous() and x.data_ptr() % 16 == 2 * offset % 16
    before = k3.quantize_launches
    xp, x_scale = k3.quantize_pack_activations_cuda(x, p)
    torch.cuda.synchronize()
    assert k3.quantize_launches == before + 1
    want_xp, want_xs = k3.quantize_pack_activations_plain(x, p)
    assert xp.shape == want_xp.shape and xp.dtype == torch.int8
    assert int((xp != want_xp).sum()) == 0
    assert torch.equal(x_scale.view(torch.int32), want_xs.view(torch.int32))
    assert int(xp[0].abs().sum()) == 0


@pytest.mark.parametrize("o,i", [(200, 64), (64, 33), (256, 512), (200, 200)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weight_quantizer_equals_plain_at_its_plan_edges(cuda, o, i, dtype):
    """The weight quantizer kernel bit for bit against its plain version
    where its plan changes: pad channels (O = 200), rows that are no
    multiple of 16 bytes (I = 33: plain loads instead of bulk copies), one
    channel a CTA (O = 256), an all-zero channel."""
    from afcm_tpu_torch.ops.cuda import conv_int8 as k3
    rng = np.random.RandomState(o + i)
    w = torch.from_numpy((rng.randn(o, i, 3, 3) / np.sqrt(9 * i)).astype(np.float32))
    w[1] = 0
    w = w.to(cuda, dtype)
    before = k3.weight_quantize_launches
    wp, w_scale = k3.quantize_pack_weights_cuda(w)
    torch.cuda.synchronize()
    assert k3.weight_quantize_launches == before + 1
    want_wp, want_ws = k3.quantize_pack_weights_plain(w)
    assert wp.shape == want_wp.shape and int((wp != want_wp).sum()) == 0
    assert torch.equal(w_scale.view(torch.int32), want_ws.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantizers_equal_plain_at_near_ties(cuda, dtype):
    """Values whose quotient by the scale lies a few units in the last place
    from a half-integer, on both sides (the kernels divide only where the
    rounding can depend on the IEEE quotient): both quantizers bit-equal to
    their plain versions, at scales near 1, at the floor and near float32's
    largest."""
    from afcm_tpu_torch.ops.cuda import conv_int8 as k3
    rng = np.random.RandomState(11)
    amaxes = [127.0, 100.0, 3.7, 1e-9, 2e36, 0.0123]

    def near_ties(shape, amax):
        scale = np.float32(max(np.float32(amax), np.float32(1e-8))) / np.float32(127)
        k = rng.randint(-127, 127, size=int(np.prod(shape))) + 0.5
        v = (k * np.float64(scale)).astype(np.float32)
        v = (v.view(np.int32) + rng.randint(-4, 5, size=v.size).astype(np.int32)).view(np.float32)
        v = np.clip(v, -np.float32(amax), np.float32(amax))
        v[0] = amax
        return v.reshape(shape)

    x = np.stack([near_ties((64, 12, 12), a) for a in amaxes])
    w = np.stack([near_ties((64, 3, 3), amaxes[o % len(amaxes)]) for o in range(200)])
    xt = torch.from_numpy(x).to(cuda, dtype)
    wt = torch.from_numpy(w).to(cuda, dtype)
    xp, x_scale = k3.quantize_pack_activations_cuda(xt, 1)
    want_xp, want_xs = k3.quantize_pack_activations_plain(xt, 1)
    assert int((xp != want_xp).sum()) == 0
    assert torch.equal(x_scale.view(torch.int32), want_xs.view(torch.int32))
    wp, w_scale = k3.quantize_pack_weights_cuda(wt)
    want_wp, want_ws = k3.quantize_pack_weights_plain(wt)
    assert int((wp != want_wp).sum()) == 0
    assert torch.equal(w_scale.view(torch.int32), want_ws.view(torch.int32))


def test_activation_quantizer_on_two_streams_at_once(cuda):
    """Two calls on two streams at once, each with its own scratch: both
    bit-equal to the plain version."""
    from afcm_tpu_torch.ops.cuda import conv_int8 as k3
    xs = [_quant_x(cuda, 16, 512, 36, torch.bfloat16, 0, seed=7),
          _quant_x(cuda, 16, 512, 38, torch.bfloat16, 0, seed=8)]
    pads = [2, 0]
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    torch.cuda.synchronize()
    got = []
    for x, p, st in zip(xs, pads, streams):
        with torch.cuda.stream(st):
            got.append(k3.quantize_pack_activations_cuda(x, p))
    torch.cuda.synchronize()
    for x, p, (xp, x_scale) in zip(xs, pads, got):
        want_xp, want_xs = k3.quantize_pack_activations_plain(x, p)
        assert int((xp != want_xp).sum()) == 0
        assert torch.equal(x_scale.view(torch.int32), want_xs.view(torch.int32))


# (n, i, h, p, itemsize, address % 16) of x and (o, i, itemsize, address %
# 16) of w: the routed inputs and the edges tests/test_torch_quantizer_plans.py
# replays the kernels' stores at
QUANT_PLAN_X = [(16, 512, 36, 2, 2, 0), (16, 512, 52, 2, 2, 0), (16, 512, 38, 0, 2, 0),
                (16, 512, 10, 0, 4, 0), (16, 512, 18, 0, 4, 0), (16, 512, 34, 0, 4, 0),
                (1, 512, 36, 2, 2, 0), (3, 200, 9, 1, 2, 0), (2, 200, 4, 2, 4, 0),
                (2, 91, 41, 1, 4, 8), (64, 512, 36, 2, 2, 0), (3, 48, 38, 2, 2, 2),
                (3, 33, 7, 0, 2, 0), (2, 40, 4, 1, 2, 4)]
QUANT_PLAN_W = [(512, 512, 4, 0), (256, 512, 4, 0), (512, 512, 2, 0), (200, 33, 4, 0),
                (200, 200, 2, 0), (96, 40, 4, 8), (40, 48, 2, 2)]


def test_quantizer_plans_of_the_kernels_are_the_mirrors(cuda):
    """csrc/quantize_int8.cu's plans, exported by afcm_quantize_*_plan with
    the kernels' shared memory as compiled, against their Python mirrors
    plan_quantize_activations / plan_quantize_weights on this card's SMs;
    both refuse a weight row beyond a CTA's shared memory, and so does the
    weight quantizer's wrapper."""
    from afcm_tpu_torch.ops.cuda import conv_int8 as k3
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for n, i, h, p, itemsize, address in QUANT_PLAN_X:
        assert k3.kernel_activation_plan(n, i, h, h, p, itemsize, address) == \
            k3.plan_quantize_activations(n, i, h, h, p, itemsize, address, sms)
    for o, i, itemsize, address in QUANT_PLAN_W:
        assert k3.kernel_weight_plan(o, i, itemsize, address) == \
            k3.plan_quantize_weights(o, i, itemsize, address)
    with pytest.raises(ValueError, match="shared memory"):
        k3.plan_quantize_weights(64, 7000, 4)
    with pytest.raises(RuntimeError, match="afcm_quantize_weights_plan"):
        k3.kernel_weight_plan(64, 7000, 4)
    with pytest.raises(RuntimeError, match="weight kernel failed"):
        k3.quantize_pack_weights_cuda(torch.zeros((64, 7000, 3, 3), device=cuda))


def test_conv_int8_kernel_matches_jax_full_size(cuda, jax_ops):
    """K3 at the serving path's shape (512 -> 512 at 36^2, padding 2)
    against the JAX package's kernel in interpret mode on JAX's CPU backend:
    within 1 bf16 ulp (the fp32 scale product may be ordered differently)."""
    jax, _ = jax_ops
    jk3 = pytest.importorskip("afcm_tpu.ops.pallas.conv_int8")
    from afcm_tpu_torch.ops.cuda import conv_int8 as k3
    (x, w, _), (xt, wt, _), p = _int8_case("path_512_36_p2", cuda, n=1)
    with jax.default_device(jax.devices("cpu")[0]):
        want = np.asarray(jk3.conv3x3_int8(jax.numpy.asarray(x), jax.numpy.asarray(w),
                                           padding=p, interpret=True), np.float32)
    got = k3.conv3x3_int8(xt, wt, p).float().cpu().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert got.shape == want.shape == (1, 512, 38, 38)
    assert np.all(np.abs(got - want) <= ulp)


def test_conv_int8_raises_instead_of_falling_back(cuda):
    from afcm_tpu_torch.ops.cuda import conv_int8 as k3
    x = torch.randn(1, 64, 16, 16, device=cuda)
    w = torch.randn(64, 64, 3, 3, device=cuda)
    with pytest.raises(ValueError, match="int8_routable"):
        k3.conv3x3_int8(x, w, padding=3)
    with pytest.raises(ValueError, match="contiguous"):
        k3.int8_conv_cuda(torch.zeros(1, 18, 18, 64, dtype=torch.int8, device=cuda),
                          torch.zeros(2, 2, 9, 2, 64, 16, dtype=torch.int8),
                          torch.ones(1, 64, device=cuda), 64)
    with pytest.raises(ValueError, match="pack_weights"):       # the flat layout
        k3.int8_conv_cuda(torch.zeros(1, 18, 18, 64, dtype=torch.int8, device=cuda),
                          torch.zeros(9, 128, 64, dtype=torch.int8, device=cuda),
                          torch.ones(1, 64, device=cuda), 64)


def test_conv_int8_ste_backward(cuda):
    """K4: K3 forward (one launch), and the gradients of the fp32 conv at
    the unquantized x and w: against the plain path's and against
    F.conv2d's autograd at 1e-4 of the largest gradient."""
    from afcm_tpu_torch.ops.cuda import conv_int8 as k3
    _, (x, w, _), p = _int8_case("path_512_36_p2", cuda)
    g = torch.randn((2, 512, 38, 38), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(1))

    def grads(fn):
        xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        (fn(xg, wg).float() * g).sum().backward()
        return xg.grad, wg.grad

    launches = k3.launches
    dx, dw = grads(lambda a, b: k3.conv3x3_int8_ste(a, b, p))
    assert k3.launches == launches + 1
    g_seen = g.bfloat16().float()       # the bf16 output's gradient arrives in bf16
    want_dx, want_dw = torch.autograd.grad(
        (torch.nn.functional.conv2d(xr := x.clone().requires_grad_(True),
                                    wr := w.clone().requires_grad_(True),
                                    padding=p) * g_seen).sum(), (xr, wr))
    for got, want in ((dx, want_dx), (dw, want_dw)):
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()) + 1e-5


# The probe kernels (K5-K9, ops/cuda/probe_stream.py and probe_int8.py): each
# against its plain version on the same CUDA tensors, bit for bit (copies,
# powers of two, bf16 sums in a fixed order and integer products have no
# tolerance), at a small shape and at an odd one: W 276 for the streams
# (rows of 552 bytes), a plane that is no multiple of 16 bytes (the 2-byte
# path), windows that start below 0.

def _bits(t):
    return t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _probe_bf16(cuda, shape, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)


def _off2(x):
    """The same values as a contiguous view that starts 2 bytes past a
    16-byte boundary (the allocator's blocks are 512-byte aligned)."""
    buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    view = buf[1:1 + x.numel()].view(x.shape)
    view.copy_(x)
    assert view.data_ptr() % 16 == 2
    return view


# "short": a span under 16 bytes; "fir_full": fir_roofline's C128@276 x16
# (312 MB; the flat copy's CTAs each take 0.79 MB, beyond their 64 KB ring);
# "_off2": a view 2 bytes off a 16-byte boundary.
STREAM_SHAPES = {"small": (8, 16, 24), "w276": (6, 10, 276), "odd_plane": (5, 7, 9),
                 "w276_off2": (6, 10, 276), "short": (1, 1, 5), "short_off2": (1, 1, 5),
                 "fir_full": (2048, 276, 276)}


@pytest.mark.parametrize("shape", sorted(STREAM_SHAPES))
@pytest.mark.parametrize("kernel", ["copy", "wr4x", "rd4x", "chain", "chain_max_tile"])
def test_probe_stream_kernel_equals_plain_bitwise(cuda, kernel, shape):
    from afcm_tpu_torch.ops.cuda import probe_stream as ps
    c, h, w = STREAM_SHAPES[shape]
    x = _probe_bf16(cuda, (c, 4, h, w) if kernel == "rd4x" else (c, h, w))
    if shape.endswith("_off2"):
        x = _off2(x)
    fn, plain, name = {
        "copy": (ps.stream_copy, ps.stream_copy_plain, "copy"),
        "wr4x": (ps.stream_wr4x, ps.stream_wr4x_plain, "wr4x"),
        "rd4x": (ps.stream_rd4x, ps.stream_rd4x_plain, "rd4x"),
        "chain": (ps.stream_chain, ps.stream_chain_plain, "chain"),
        "chain_max_tile": (lambda t: ps.stream_chain(t, tile=ps.CHAIN_TILE_MAX),
                           ps.stream_chain_plain, "chain")}[kernel]
    before = ps.launches[name]
    got = fn(x)
    torch.cuda.synchronize()
    want = plain(x)
    assert ps.launches[name] == before + 1
    assert got.shape == want.shape and got.dtype == want.dtype
    assert int((_bits(got) != _bits(want)).sum()) == 0


# (kernel, shape, cb or br, view 2 bytes off alignment): small and ragged
# blocks, a block of 141 KB in one CTA (beyond the 64 KB ring), spans under
# 16 bytes a CTA, and every cb and br of probes/stream_diag.py at full size.
COPY_ROWS_CASES = {
    "copy3d_w276_cb2": ("copy3d", (8, 9, 276), 2, False),
    "copy3d_w20_cb4": ("copy3d", (8, 6, 20), 4, False),
    "copy2d_br3": ("copy2d", (30, 64), 3, False),
    "copy2d_ragged": ("copy2d", (31, 72), 8, False),
    "copy3d_w276_cb2_off2": ("copy3d", (8, 9, 276), 2, True),
    "copy2d_ragged_off2": ("copy2d", (31, 72), 8, True),
    "copy3d_cb1_off2": ("copy3d", (5, 7, 9), 1, True),
    "copy3d_one_cta_beyond_ring": ("copy3d", (4, 64, 276), 4, False),
    "copy3d_one_cta_beyond_ring_off2": ("copy3d", (4, 64, 276), 4, True),
    "copy2d_short": ("copy2d", (9, 3), 2, False),
    "copy2d_short_off2": ("copy2d", (9, 3), 2, True),
    **{f"copy3d_full_cb{cb}": ("copy3d", (8192, 276, 276), cb, False) for cb in (4, 8, 16)},
    **{f"copy2d_full_br{br}": ("copy2d", (1218816, 512), br, False)
       for br in (2048, 4096, 8192)},
}


@pytest.mark.parametrize("case", list(COPY_ROWS_CASES))
def test_probe_copy_rows_equals_input(cuda, case):
    from afcm_tpu_torch.ops.cuda import probe_stream as ps
    kernel, shape, block, off2 = COPY_ROWS_CASES[case]
    x = _probe_bf16(cuda, shape)
    if off2:
        x = _off2(x)
    before = ps.launches[kernel]
    got = getattr(ps, kernel)(x, block)
    torch.cuda.synchronize()
    assert ps.launches[kernel] == before + 1
    assert got.shape == x.shape and got.data_ptr() != x.data_ptr()
    assert int((_bits(got) != _bits(x)).sum()) == 0
    del got, x
    torch.cuda.empty_cache()


def test_probe_flat_copy_leaves_its_claim_counter_at_zero(cuda):
    """The flat copy's CTAs claim pieces from a counter that the last CTA
    zeroes, so back-to-back launches on one stream each copy everything."""
    from afcm_tpu_torch.ops.cuda import probe_stream as ps
    x = _probe_bf16(cuda, (64, 276, 276))
    outs = [ps.stream_copy(x) for _ in range(3)]
    torch.cuda.synchronize()
    for got in outs:
        assert int((_bits(got) != _bits(x)).sum()) == 0
    assert int(ps._claims(x.device).abs().sum()) == 0


# (x's shape, element_windows' arguments): the TPU probe's four cases on
# [8, 64, 512] (spans of 3 chunks), K1's windows (two dimensions, starting
# below 0, crop), windows past H and W with odd sizes and c_out 7 (spans
# that start and end off 16 bytes: plain head and tail), variant A's
# geometry on a single plane of 278^2 (c_out 1), and 6 channels of wide
# windows (head, three chunks, tail).
WINDOW_CASES = {
    "stride_64": ((8, 64, 512), dict(win_w=128, n_tw=4, stride_w=64)),
    "stride_48": ((8, 64, 512), dict(win_w=128, n_tw=4, stride_w=48)),
    "zero_pad_below_0_and_past_w": ((8, 64, 512),
                                    dict(win_w=128, n_tw=5, stride_w=112, lo_w=16)),
    "channel_pad": ((8, 64, 512), dict(win_w=128, n_tw=2, stride_w=128, c_out=16)),
    "two_dims_negative_start": ((8, 64, 512), dict(win_w=39, n_tw=5, stride_w=28, lo_w=5,
                                                   win_h=39, n_th=3, stride_h=28, lo_h=5)),
    "crop": ((8, 64, 512), dict(win_w=43, n_tw=3, stride_w=32, lo_w=-5, win_h=43, n_th=2,
                                stride_h=32, lo_h=-5)),
    "odd_past_h_and_w_c_out_7": ((5, 30, 40), dict(win_w=7, n_tw=8, stride_w=6, lo_w=3,
                                                   win_h=9, n_th=5, stride_h=7, lo_h=4,
                                                   c_out=7)),
    "w278_single_plane": ((1, 278, 278), dict(win_w=39, n_tw=10, stride_w=28, lo_w=5,
                                              win_h=39, n_th=10, stride_h=28, lo_h=5)),
    "wide_c_out_6_chunks": ((6, 50, 300), dict(win_w=150, n_tw=3, stride_w=75, lo_w=20,
                                               win_h=50, n_th=1, stride_h=0, lo_h=0)),
}


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_probe_windows_equal_plain_bitwise(cuda, case):
    from afcm_tpu_torch.ops.cuda import probe_stream as ps
    gen = torch.Generator(device=cuda).manual_seed(3)
    shape, kw = WINDOW_CASES[case]
    x = torch.randn(shape, generator=gen, device=cuda)
    before = ps.launches["windows"]
    got = ps.element_windows(x, **kw)
    torch.cuda.synchronize()
    want = ps.element_windows_plain(x, **kw)
    assert ps.launches["windows"] == before + 1
    assert got.shape == want.shape
    assert int((_bits(got) != _bits(want)).sum()) == 0


def _probe_int8(cuda, shape, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randint(-127, 127, shape, generator=gen, device=cuda, dtype=torch.int8)


@pytest.mark.parametrize("shape", [(128, 64, 128, 2), (256, 192, 384, 3)])
@pytest.mark.parametrize("b_layout", ["kil", "kli"])
def test_probe_stacked_matmul_equals_plain(cuda, b_layout, shape):
    from afcm_tpu_torch.ops.cuda import probe_int8 as p8
    o, i, l, k = shape
    a, b = _probe_int8(cuda, (o, i), 1), _probe_int8(cuda, (k, i, l), 2)
    if b_layout == "kli":
        b = b.transpose(1, 2).contiguous()
    before = p8.launches["stacked_matmul"]
    got = p8.stacked_matmul_int8(a, b, b_layout)
    torch.cuda.synchronize()
    assert p8.launches["stacked_matmul"] == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, p8.stacked_matmul_int8_plain(a, b, b_layout))


@pytest.mark.parametrize("geometry", [(128, 64, 128, 8, 2), (256, 128, 256, 160, 2),
                                      (128, 192, 128, 21, 1)])
@pytest.mark.parametrize("mode", ["dot1", "aligned", "slices", "sliceonly"])
def test_probe_nine_tap_equals_plain_bitwise(cuda, mode, geometry):
    """wp 8 and 160 give offsets 1 and 2 bytes off the 4-byte grid; wp 21
    gives every residue of 8."""
    from afcm_tpu_torch.ops.cuda import probe_int8 as p8
    o, i, cols, wp, steps = geometry
    p = -(-(cols + 2 * wp + 2) // 128) * 128
    w9, x = _probe_int8(cuda, (9, o, i), 4), _probe_int8(cuda, (steps, i, p), 5)
    got = p8.nine_tap_int8(w9, x, mode, cols, wp)
    torch.cuda.synchronize()
    want = p8.nine_tap_int8_plain(w9, x, mode, cols, wp)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert int((_bits(got) != _bits(want)).sum()) == 0


# slice_sum_kernel (K9 sliceonly) apart from the probe's geometry: (offsets,
# cols, S, O, I, P beyond cols + max offset, x a view 8 bytes off 16). A
# unit is 8 rows at these widths: "many_units_a_cta" gives every CTA of the
# persistent grid several units (and the x ring several rounds); I of 13
# ends the live rows inside a unit; I > O leaves no zero row; a unit
# straddling I zeroes its dead rows; P % 16 == 8 and the view start every
# other unit's span 8 bytes off 16 (plain loads of its first and last 8
# bytes). Nine offsets in three runs of three neighbours take the kernel's
# run path (its runs starting at every residue mod 4 across the cases),
# other offsets the general one.
SLICE_CASES = {
    "p_mod_16_is_8": ([0, 1, 2, 160, 161, 162, 320, 321, 322], 128, 3, 24, 24, 8, False),
    "x_view_8_bytes_off": ([0, 1, 2, 21, 22, 23, 42, 43, 44], 64, 2, 16, 16, 0, True),
    "many_units_a_cta": ([0, 1, 2, 160, 161, 162, 320, 321, 322], 256, 400, 64, 48, 0, False),
    "i_not_a_multiple_of_the_unit": ([5, 3, 9], 64, 3, 16, 13, 0, False),
    "i_greater_than_o": ([0, 1, 2, 8, 9, 10, 16, 17, 18], 64, 2, 24, 40, 0, False),
    "unit_straddling_i": ([2, 0, 1], 128, 2, 20, 12, 0, False),
    "one_tap": ([7], 128, 3, 16, 16, 0, False),
    "far_apart": ([0, 1, 1500, 2999, 3001, 17, 4000, 4007, 2], 256, 2, 16, 12, 8, False),
    "runs_at_residue_3": ([49, 3, 24, 4, 47, 5, 23, 25, 48], 128, 2, 16, 16, 8, False),
    "nine_taps_not_in_runs": ([0, 1, 2, 10, 11, 13, 20, 21, 22], 128, 2, 16, 16, 0, False),
}


@pytest.mark.parametrize("case", list(SLICE_CASES))
def test_probe_slice_sum_equals_plain_bitwise(cuda, case):
    from afcm_tpu_torch.ops.cuda import probe_int8 as p8
    offsets, cols, s, o, i, extra, off8 = SLICE_CASES[case]
    p = -(-(cols + max(offsets)) // 16) * 16 + extra
    x = _probe_int8(cuda, (s, i, p), 8)
    if off8:
        buf = torch.empty(x.numel() + 16, dtype=torch.int8, device=cuda)
        x = buf[8:8 + x.numel()].view(x.shape).copy_(x)
        assert x.data_ptr() % 16 == 8
    before = dict(p8.launches)
    got = p8.slice_sum_int8(x, offsets, o, cols)
    torch.cuda.synchronize()
    want = p8.slice_sum_int8_plain(x, offsets, o, cols)
    assert p8.launches == {**before, "slice_sum": before["slice_sum"] + 1}
    assert got.shape == want.shape == (s, o, cols) and got.dtype == torch.bfloat16
    assert int((_bits(got) != _bits(want)).sum()) == 0


def test_probe_slice_plan_of_the_kernel_is_plan_slice_sum(cuda):
    """csrc/probe_int8.cu's make_slice_plan, exported by
    afcm_slice_sum_plan, against its Python mirror plan_slice_sum."""
    from afcm_tpu_torch.ops.cuda import probe_int8 as p8
    for o, i, p, n in [(512, 384, 2304, 1920), (128, 64, 256, 128), (16, 16, 16, 8),
                       (20, 12, 256, 128), (64, 48, 592, 256), (16, 12, 4272, 256),
                       (8, 8, 14000, 6000), (4, 4, 30000, 20000)]:
        assert p8.kernel_slice_plan(o, i, p, n) == p8.plan_slice_sum(o, i, p, n), (o, i, p, n)


# taps_matmul_kernel (K8, K9) at taps 1 and 9: (offsets, cols, raw, out
# dtype, S, O, I, P beyond cols + max offset, x a view 8 bytes off 16).
# Offsets cover every residue mod 16 and reach past the 256-column tile;
# cols of 128 and 384 leave a tile half empty; "many_tiles" give a CTA of
# the persistent grid several tiles (int32: the staging region in turns)
# and steps of several K slices; K-major offsets of whole 8-row atoms take
# x's rows of 32 bytes in the 32-byte swizzle; "far_apart" spreads the taps
# beyond one ring (one tap a step), on 16-byte starts too (raw x by tensor
# map); a span starting off 16 bytes takes raw x by cp.async; P % 16 == 8
# and the view take 8-byte raw pieces.
TAPS_CASES = {
    "residues_0_to_8_int32": (list(range(9)), 256, True, torch.int32, 2, 128, 64, 0, False),
    "residues_9_to_15_past_the_tile": ([9, 10, 11, 12, 13, 14, 15, 300, 517], 384, True,
                                       torch.bfloat16, 1, 256, 128, 0, False),
    "unsorted_k_major_bf16": ([322, 0, 161, 1, 2, 160, 320, 321, 162], 512, False,
                              torch.bfloat16, 2, 128, 192, 0, False),
    "k_major_int32_past_the_tile": ([0, 5, 33, 257, 258, 290, 300, 311, 400], 256, False,
                                    torch.int32, 1, 128, 64, 0, False),
    "one_tap_s1_o128_i64": ([0], 128, True, torch.bfloat16, 1, 128, 64, 0, False),
    "one_tap_k_major_offset_7": ([7], 384, False, torch.int32, 3, 128, 64, 0, False),
    "far_apart": ([0, 1, 1500, 2999, 3001, 17, 4000, 4007, 2], 256, True, torch.int32, 1,
                  128, 64, 0, False),
    "p_mod_16_is_8": ([0, 3, 6, 9, 12, 15, 18, 21, 24], 256, True, torch.int32, 2, 128, 64,
                      8, False),
    "far_apart_on_16_bytes": ([0, 16, 1504, 2992, 3008, 32, 4000, 4016, 48], 256, True,
                              torch.bfloat16, 1, 128, 64, 0, False),
    "one_group_off_16_bytes": ([5, 6, 7, 165, 166, 167, 325, 326, 327], 256, True,
                               torch.bfloat16, 2, 128, 64, 0, False),
    "many_tiles_a_cta_int32": ([0, 16], 256, True, torch.int32, 300, 128, 128, 0, False),
    "many_tiles_a_cta_k_major": ([0], 384, False, torch.int32, 150, 128, 256, 0, False),
    "k_major_offsets_of_8_rows": ([8, 0, 16, 264, 40], 256, False, torch.bfloat16, 2, 128, 128,
                                  0, False),
    "x_view_8_bytes_off": ([0, 1, 2, 160, 161, 162, 320, 321, 322], 128, True,
                           torch.bfloat16, 2, 128, 128, 0, True),
}


@pytest.mark.parametrize("case", list(TAPS_CASES))
def test_probe_taps_matmul_equals_plain_bitwise(cuda, case):
    from afcm_tpu_torch.ops.cuda import probe_int8 as p8
    offsets, cols, raw, dtype, s, o, i, extra, off8 = TAPS_CASES[case]
    p = -(-(cols + max(offsets)) // 16) * 16 + extra
    w = _probe_int8(cuda, (len(offsets), o, i), 6)
    x = _probe_int8(cuda, (s, i, p) if raw else (s, p, i), 7)
    if off8:
        buf = torch.empty(x.numel() + 16, dtype=torch.int8, device=cuda)
        x = buf[8:8 + x.numel()].view(x.shape).copy_(x)
        assert x.data_ptr() % 16 == 8
    before = p8.launches["nine_tap"]
    got = p8.taps_matmul_int8(w, x, offsets, cols, raw=raw, out_dtype=dtype)
    torch.cuda.synchronize()
    want = p8.taps_matmul_int8_plain(w, x, offsets, cols, raw, dtype)
    assert p8.launches["nine_tap"] == before + 1
    assert got.shape == want.shape == (s, o, cols) and got.dtype == dtype
    assert int((_bits(got) != _bits(want)).sum()) == 0


@pytest.mark.parametrize("raw,tma_ok", [(True, True), (True, False), (False, True)])
def test_probe_taps_plan_of_the_kernel_is_plan_taps(cuda, raw, tma_ok):
    """csrc/probe_int8.cu's make_plan, exported by afcm_taps_plan, against
    its Python mirror plan_taps, at the probes' taps and the test cases'."""
    from afcm_tpu_torch.ops.cuda import probe_int8 as p8
    sets = [[0], p8.tap_offsets("slices", 160), p8.tap_offsets("aligned", 160),
            p8.tap_offsets("slices", 21)] + [c[0] for c in TAPS_CASES.values()]
    for offsets in sets:
        for i in (64, 128, 384, 512):
            for out_bytes in (2, 4):
                assert p8.kernel_plan(offsets, i, raw, out_bytes, tma_ok) == \
                    p8.plan_taps(offsets, i, raw, out_bytes, tma_ok), (offsets, i, out_bytes)


def test_probe_kernels_raise_instead_of_falling_back(cuda):
    from afcm_tpu_torch.ops.cuda import probe_int8 as p8
    from afcm_tpu_torch.ops.cuda import probe_stream as ps
    with pytest.raises(ValueError, match="contiguous"):
        ps.stream_chain(_probe_bf16(cuda, (4, 8, 16))[:, :, ::2])
    with pytest.raises(ValueError, match="multiples"):
        p8.stacked_matmul_int8(_probe_int8(cuda, (96, 64), 0), _probe_int8(cuda, (1, 64, 128), 1))
    with pytest.raises(ValueError, match="one device"):
        p8.stacked_matmul_int8(_probe_int8(cuda, (128, 64), 0),
                               torch.zeros((1, 64, 128), dtype=torch.int8))
    with pytest.raises(ValueError, match="multiples"):
        p8.nine_tap_int8(_probe_int8(cuda, (9, 128, 64), 0), _probe_int8(cuda, (1, 64, 256), 1),
                         "slices", 100, 8)


@pytest.mark.parametrize("name", ["A_u2d2", "odd_nonsquare_nobias", "u3d2"])
def test_operators_pass_opcheck_on_the_card(cuda, name):
    """The custom operators' CUDA kernels (K1, K2) under
    torch.library.opcheck: schema, fake shapes against the kernel's output,
    the registered backward, AOTAutograd with dynamic shapes."""
    x, b, kw = _case(CASES[name], cuda)
    taps_u, taps_d, *pad = k1.op_arguments(kw["fu"], kw["fd"], kw["padding"],
                                           kw["flip_filter"])
    args = (taps_u, taps_d, kw["up"], kw["down"], *pad, float(kw["gain"]), kw["slope"],
            kw["clamp"])
    bg = None if b is None else b.clone().requires_grad_(True)
    torch.library.opcheck(k1.filtered_lrelu_op, (x.clone().requires_grad_(True), bg) + args)
    y = k1.filtered_lrelu_op(x, b, *args)
    torch.testing.assert_close(y, k1.filtered_lrelu_cuda(x, b=b, **kw), rtol=0, atol=0)
    torch.library.opcheck(k1.filtered_lrelu_bwd_op, (x, b, torch.randn_like(y)) + args)


def test_exported_generator_launches_k1(cuda):
    """A tiny alias-free generator exported on the card keeps its
    filtered_lrelu calls as operator nodes: the loaded artifact launches K1
    once per node and equals the in-process eval step."""
    from afcm_tpu_torch.infer import export
    from afcm_tpu_torch.models import build_eval_model
    g_cfg = dict(netG="stylegan3", z_dim=32, c_dim=1, w_dim=32, img_resolution=64,
                 img_channels_in=4, img_channels_out=1, mapping_kwargs=dict(num_layers=2),
                 synthesis_kwargs=dict(channel_base=1024, channel_max=16, num_layers=8,
                                       num_critical=2, margin_size=10, skip_resolution=32,
                                       lrelu_upsampling=2, conv_clamp=256))
    model = build_eval_model(g_cfg, generator=torch.Generator().manual_seed(0))
    model.generator_ema.to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    a = torch.rand((3, 4, 64, 64), generator=gen, device=cuda) * 2 - 1
    s = torch.rand((3, 1), generator=gen, device=cuda)
    z = torch.randn((3, 32), generator=gen, device=cuda)
    exported = export.export_eval(model, None, (4, 64, 64))
    nodes = export.count_nodes(exported)
    before = k1.launches
    got = exported.module()(a, s, z)
    torch.cuda.synchronize()
    assert nodes == 16 and k1.launches - before == nodes
    torch.testing.assert_close(got, model.eval_step(a, s, z=z), rtol=0, atol=1e-6)


def _bench_config(name):
    """The config tree a benchmark cell runs (``portbench/configs``)."""
    import json
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "portbench", "configs", f"{name}.json")) as f:
        return json.load(f)["config"]


def test_fir_resampling_enqueues_without_waiting_for_the_card(cuda):
    """After one warm-up call, the CCSR EMA generator's forward at batch 16
    and the CMSR discriminator behind the blur at sigma 10 (its start in
    training) run on inputs already on the card under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises at any call
    that waits for the card: the FIR weights come from ``ops/upfirdn2d``'s
    cache, the blur's sigma is filled in on the card."""
    import importlib

    from afcm_tpu_torch.models import build_discriminator, build_eval_model
    from afcm_tpu_torch.models.gan_model import eval_forward
    from afcm_tpu_torch.ops import gaussian_blur2d
    fir = importlib.import_module("afcm_tpu_torch.ops.upfirdn2d")
    ccsr, cmsr = _bench_config("ccsr_adni"), _bench_config("cmsr_adni")
    g_ema = build_eval_model(dict(ccsr["model"]["G"]),
                             generator=torch.Generator().manual_seed(0)).generator_ema
    g_ema.to(cuda)
    d = build_discriminator(dict(cmsr["model"]["D"], compute_dtype="bfloat16"),
                            generator=torch.Generator().manual_seed(1)).to(cuda)
    sigma = float(cmsr["loss"]["blur_init_sigma"])
    gen = torch.Generator(device=cuda).manual_seed(2)
    a = torch.rand((16, 4, 256, 256), generator=gen, device=cuda) * 2 - 1
    s = torch.rand((16, 1), generator=gen, device=cuda)
    z = torch.randn((16, 512), generator=gen, device=cuda)
    img = torch.rand((16, 5, 256, 256), generator=gen, device=cuda) * 2 - 1

    def serve():
        with torch.inference_mode():
            return eval_forward(g_ema, 1, a, s, z)

    def discriminate():
        return d(gaussian_blur2d(img, sigma, max_radius=int(np.floor(sigma * 3))), s)

    for run in (serve, discriminate):
        run()
        torch.cuda.synchronize()
        uploads, hits = fir.tap_uploads, fir.tap_hits
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.isfinite(out).all()
        assert fir.tap_uploads == uploads and fir.tap_hits > hits, run.__name__
