"""What surrounds the redesigned kernels K1, K2, K3 and the probes' bulk copy
(K5a, K6), product kernel (K8, K9) and window kernel (K7) and runs on the
CPU: K1's and K2's tile planners, K3's tile choice, the plain versions of
the quantizer kernels against the JAX package's quantization, the bulk
copy's planner (its grid, ring and tiling of the span) and its aligned
output, the product kernel's plan (tap groups, span, ring, shared memory)
and the window kernel's CTA work.

The kernels themselves run only on the card (tests/test_torch_cuda.py); the
planner decides which instantiation takes a call and how much shared memory
it gets, so its answers are held here for every ``filtered_lrelu`` layer of
the shipped generator and of the tiny one. The quantizers are exact in both
packages (same divide, round half to even, clip), so the comparisons are
exact too. Inputs are made with numpy from a seed.
"""

import os
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from afcm_tpu_torch.models import CMSR_ADNI_G, build_generator  # noqa: E402
from afcm_tpu_torch.ops import design_lowpass_filter  # noqa: E402
from afcm_tpu_torch.ops.cuda import conv_int8 as k3  # noqa: E402
from afcm_tpu_torch.ops.cuda import filtered_lrelu as k1  # noqa: E402
from afcm_tpu_torch.ops.cuda import probe_int8 as p8  # noqa: E402
from afcm_tpu_torch.ops.cuda import probe_stream as ps  # noqa: E402

torch.set_num_threads(1)

TINY = dict(netG="stylegan3", z_dim=64, c_dim=1, w_dim=64, img_resolution=64,
            img_channels_in=4, img_channels_out=1, mapping_kwargs=dict(num_layers=2),
            synthesis_kwargs=dict(channel_base=1024, channel_max=32,
                                  num_layers=6, num_critical=2, margin_size=10,
                                  skip_resolution=32, conv_clamp=256))
# Filter geometry (up, down, up taps, down taps) of the shipped generator's
# variants: A and D (D is A's filters with another crop), B, C.
SHIPPED_GEOMETRIES = {"A/D": (2, 2, 12, 12), "B": (2, 4, 12, 24), "C": (4, 2, 24, 12)}


def _layers(gen_kwargs):
    """(name, up, down, up taps, down taps, kernel input size, output size)
    of every layer that launches the filtered_lrelu kernels: the kernel's
    input is the 3x3 conv's output, layer size + 2."""
    synthesis = build_generator(gen_kwargs).synthesis
    out = []
    for side, layers in (("encoder", synthesis.encoders), ("decoder", synthesis.decoders)):
        for idx, layer in enumerate(layers):
            if layer.spec.is_torgb:
                continue
            taps = [1 if f is None else len(f) for f in (layer.up_filter, layer.down_filter)]
            out.append((f"{side}_{idx}", layer.up, layer.down, *taps,
                        layer.spec.in_size + 2, layer.spec.out_size))
    return out


@pytest.fixture(scope="module", params=["shipped", "tiny"])
def layers(request):
    return _layers(CMSR_ADNI_G if request.param == "shipped" else TINY)


def test_bwd_plan_fits_two_ctas_and_covers_the_image(layers):
    """Every layer's plan keeps two CTAs on an SM (dynamic shared memory
    within ``SMEM_TWO_CTAS``, twice that plus the reserved kilobyte each
    within the SM's 228 KB), its tiles cover the image, and T is a multiple
    of 4 as the strided passes need."""
    assert len(layers) >= 10
    for name, up, down, ntu, ntd, size, _ in layers:
        plan = k1.plan_bwd_tile(up, down, ntu, ntd, size, size)
        assert plan["smem_bytes"] <= k1.SMEM_TWO_CTAS, name
        assert 2 * (plan["smem_bytes"] + 1024 + 512) <= 228 * 1024, name
        per_axis = -(-size // plan["tile"])
        assert plan["tiles"] == per_axis ** 2 and per_axis * plan["tile"] >= size, name
        assert plan["tile"] % 4 == 0 and 4 <= plan["tile"] <= 64, name


def test_bwd_plan_windows_equal_the_kernel_formulas(layers):
    """M, L and D as the header of csrc/filtered_lrelu_bwd.cu defines them,
    and the shared memory as its buffers add up: bufA max(L*L', D*D'), bufB
    max(L, D, T)*M', bufM M*M' floats between two slack areas of 64, with
    the pitches v' = v | 1 in a specialised instantiation and v' = v in the
    generic kernel."""
    for name, up, down, ntu, ntd, size, _ in layers:
        plan = k1.plan_bwd_tile(up, down, ntu, ntd, size, size)
        t = plan["tile"]
        mid = (t - 1) * up + ntu
        in_tile = int(np.ceil((mid + ntu - 2) / up)) + 1
        dy_tile = (mid + ntd - 2) // down + 1
        assert (plan["mid"], plan["in_tile"], plan["dy_tile"]) == (mid, in_tile, dy_tile), name
        assert k1.bwd_windows(t, up, down, ntu, ntd) == (mid, in_tile, dy_tile)
        odd = (lambda v: v | 1) if plan["specialised"] else (lambda v: v)
        floats = 2 * 64 + max(in_tile * odd(in_tile), dy_tile * odd(dy_tile)) \
            + max(in_tile, dy_tile, t) * odd(mid) + mid * odd(mid)
        assert plan["smem_bytes"] == 4 * floats, name
        # the dx tile is staged in bufA, and a window's overshoot of one row
        # of bufB lands in bufA
        assert t * odd(t) <= max(in_tile * odd(in_tile), dy_tile * odd(dy_tile)), name


def test_bwd_plan_picks_the_instantiation_by_geometry(layers):
    """The shipped geometries map to their own instantiations, and every
    layer of both generators has one of them."""
    assert k1.BWD_SPECIALISED == frozenset(SHIPPED_GEOMETRIES.values())
    for name, up, down, ntu, ntd, size, _ in layers:
        plan = k1.plan_bwd_tile(up, down, ntu, ntd, size, size)
        assert plan["specialised"] == ((up, down, ntu, ntd) in k1.BWD_SPECIALISED), name
    shipped = {(up, down, ntu, ntd) for _, up, down, ntu, ntd, _, _ in _layers(CMSR_ADNI_G)}
    assert shipped == set(SHIPPED_GEOMETRIES.values())


@pytest.mark.parametrize("geometry", [(3, 1, 7, 1), (1, 1, 7, 5), (3, 2, 18, 12),
                                      (2, 1, 1, 1), (2, 2, 12, 8), (1, 1, 64, 64)])
def test_bwd_plan_odd_geometry_takes_the_generic_kernel(geometry):
    """Any other geometry takes the generic kernel with plain pitches; the
    longest filters the kernels take still get a tile, at one CTA per SM."""
    plan = k1.plan_bwd_tile(*geometry, 21, 19)
    assert plan["specialised"] is False
    assert plan["smem_bytes"] <= k1.SMEM_ONE_CTA
    assert plan["tiles"] == -(-21 // plan["tile"]) * -(-19 // plan["tile"])
    if geometry != (1, 1, 64, 64):
        assert plan["smem_bytes"] <= k1.SMEM_TWO_CTAS


def test_bwd_plan_tile_grows_past_48_kb_for_the_long_filters():
    """Variant C (up 4, 24 taps) got T = 12 under a 48 KB cap; with two CTAs'
    worth of an SM it gets at least 20, so at most 1.5x of a tile's mid
    window is halo that its neighbours compute again."""
    for size in (38, 54, 86, 150):
        plan = k1.plan_bwd_tile(4, 2, 24, 12, size, size)
        assert plan["tile"] >= 20
        assert (plan["mid"] / (plan["tile"] * 4)) ** 2 <= 1.6
    assert k1.plan_bwd_tile(2, 2, 12, 12, 278, 278)["tile"] >= 48


def test_plan_object_hands_the_tile_to_the_entry_point():
    """``_Plan.bwd_tile`` gives the C entry point's six integers (T, M, L, D,
    bytes, specialised) for the call's geometry and input size."""
    fu = design_lowpass_filter(12, cutoff=9.5, width=9.5, fs=76)
    x = torch.zeros((1, 2, 38, 38))
    plan = k1._Plan(x, fu, fu, 2, 2, (9, 8, 9, 8), np.sqrt(2), 0.2, 256.0, False)
    want = k1.plan_bwd_tile(2, 2, 12, 12, 38, 38)
    assert plan.bwd_tile() == (want["tile"], want["mid"], want["in_tile"],
                               want["dy_tile"], want["smem_bytes"], 1)
    odd = k1._Plan(x, fu[:7], None, 3, 1, 0, np.sqrt(2), 0.2, None, False)
    assert odd.bwd_tile()[-1] == 0


def _fwd_windows(t, up, down, ntu, ntd, specialised):
    """M, L and E per axis as the header of csrc/filtered_lrelu.cu defines
    them, written out here from the header's words: the specialised kernel's
    up passes make whole chunks of 8 from phase 0, up - 1 samples to spare,
    and a chunk reads the x samples of its last output's taps."""
    mid = (t - 1) * down + ntd
    if not specialised:
        return mid, int(np.ceil((mid + ntu - 2) / up)) + 1, mid
    ext = int(np.ceil((mid + up - 1) / 8)) * 8
    reach = max((i + (-i) % up) // up + int(np.ceil((ntu - (-i) % up) / up))
                for i in range(8))
    return mid, ext // up - 8 // up + reach, ext


def _fwd_48kb_fmas(up, down, ntu, ntd, out):
    """FMAs per plane of the square tile K1's C++ planner chose before it
    moved to Python: T a multiple of 4 up to 64, buffers max(L², M²) +
    max(L, T)·M floats within 48 KB less the 512 bytes of static taps."""
    best = None
    for t in range(4, 65, 4):
        mid = (t - 1) * down + ntd
        in_tile = (mid + ntu - 2 + up - 1) // up + 1
        if 4 * (max(in_tile ** 2, mid ** 2) + max(in_tile, t) * mid) > 48 * 1024 - 512:
            continue
        work = (-(-out // t)) ** 2 * ((in_tile * mid + mid * mid) * -(-ntu // up)
                                   + (t * mid + t * t) * ntd)
        best = work if best is None else min(best, work)
    return best


def test_fwd_plan_fits_two_ctas_and_covers_the_image(layers):
    """Every layer's K1 plan keeps two CTAs on an SM (dynamic shared memory
    within ``SMEM_TWO_CTAS``, twice that plus the static taps and the
    reserved kilobyte within the SM's 228 KB), its tiles cover the output,
    and each side is a multiple of 8 (a specialised instantiation's strided
    chunk) or of 4 (the generic kernel)."""
    assert len(layers) >= 10
    for name, up, down, ntu, ntd, _, out in layers:
        plan = k1.plan_fwd_tile(up, down, ntu, ntd, out, out)
        assert plan["smem_bytes"] <= k1.SMEM_TWO_CTAS, name
        assert 2 * (plan["smem_bytes"] + 512 + 1024) <= 228 * 1024, name
        ty, tx = plan["tile_y"], plan["tile_x"]
        assert plan["tiles"] == -(-out // ty) * -(-out // tx), name
        assert -(-out // ty) * ty >= out and -(-out // tx) * tx >= out, name
        step = 8 if plan["specialised"] else 4
        assert ty % step == 0 and tx % step == 0 and max(ty, tx) <= 64, name


def test_fwd_plan_windows_equal_the_kernel_formulas(layers):
    """M and L per axis as the kernel's header defines them, and the shared
    memory as its buffers add up: bufA max(Ly*Lx', Ey*Mx', Ty*Tx') and bufB
    max(Ly*Ex', Ty*Mx') floats with the odd pitches v' = v | 1 of a
    specialised instantiation; max(Ly*Lx, My*Mx) and max(Ly, Ty)*Mx in the
    generic kernel. The FMAs are those of the passes as the kernel runs
    them."""
    for name, up, down, ntu, ntd, _, out in layers:
        plan = k1.plan_fwd_tile(up, down, ntu, ntd, out, out)
        spec = plan["specialised"]
        (my, ly, ey), (mx, lx, ex) = (_fwd_windows(t, up, down, ntu, ntd, spec)
                                      for t in (plan["tile_y"], plan["tile_x"]))
        assert (plan["mid_y"], plan["mid_x"], plan["in_y"], plan["in_x"]) == (my, mx, ly, lx), name
        for t, want in ((plan["tile_y"], (my, ly, ey)), (plan["tile_x"], (mx, lx, ex))):
            assert k1.fwd_windows(t, up, down, ntu, ntd, spec) == want, name
        ty, tx = plan["tile_y"], plan["tile_x"]
        if spec:
            floats = max(ly * (lx | 1), ey * (mx | 1), ty * (tx | 1)) \
                + max(ly * (ex | 1), ty * (mx | 1))
            # a chunk of the up passes never reads past the x window
            assert ey >= my + up - 1 and ex >= mx + up - 1 and ex % 8 == 0, name
        else:
            floats = max(ly * lx, my * mx) + max(ly, ty) * mx
        assert plan["smem_bytes"] == 4 * floats, name
        fmas = plan["tiles"] * ((ly * ex + mx * ey) * -(-ntu // up) + (ty * mx + ty * tx) * ntd)
        assert plan["fmas_per_plane"] == fmas, name


def test_fwd_plan_picks_the_instantiation_by_geometry(layers):
    """The shipped geometries map to K1's own instantiations (the same three
    as K2's), and every layer of both generators has one of them."""
    assert k1.FWD_SPECIALISED == frozenset(SHIPPED_GEOMETRIES.values()) == k1.BWD_SPECIALISED
    for name, up, down, ntu, ntd, _, out in layers:
        plan = k1.plan_fwd_tile(up, down, ntu, ntd, out, out)
        assert plan["specialised"] == ((up, down, ntu, ntd) in k1.FWD_SPECIALISED), name


@pytest.mark.parametrize("source,listed", [("filtered_lrelu.cu", "FWD_SPECIALISED"),
                                           ("filtered_lrelu_bwd.cu", "BWD_SPECIALISED")])
def test_kernel_sources_instantiate_the_planners_geometries(source, listed):
    """The one list of geometries in each source (AFCM_SPEC_GEOMETRIES, behind
    its dispatch and its exported list, which loading checks on the card) is
    the planner's set."""
    path = os.path.join(os.path.dirname(k1.__file__), "..", "..", "csrc", source)
    with open(path) as f:
        line = re.search(r"#define AFCM_SPEC_GEOMETRIES\(X\)(.*)", f.read()).group(1)
    built = {tuple(int(v) for v in g.split(",")) for g in re.findall(r"X\(([^)]*)\)", line)}
    assert built == set(getattr(k1, listed))


@pytest.mark.parametrize("geometry", [(3, 2, 18, 12), (1, 1, 7, 5), (3, 1, 7, 1),
                                      (2, 1, 1, 1), (2, 2, 12, 8), (1, 1, 64, 64)])
def test_fwd_plan_odd_geometry_takes_the_generic_kernel(geometry):
    """Any other geometry takes the generic kernel with plain pitches and
    tiles in steps of 4; the longest filters the kernel takes still get a
    tile, at one CTA per SM."""
    plan = k1.plan_fwd_tile(*geometry, 21, 19)
    assert plan["specialised"] is False
    assert plan["smem_bytes"] <= k1.SMEM_ONE_CTA
    assert plan["tiles"] == -(-21 // plan["tile_y"]) * -(-19 // plan["tile_x"])
    assert plan["tile_y"] % 4 == 0 and plan["tile_x"] % 4 == 0
    if geometry != (1, 1, 64, 64):
        assert plan["smem_bytes"] <= k1.SMEM_TWO_CTAS


@pytest.mark.parametrize("variant,in_size,out", [("A/D", 278, 276), ("B", 278, 148),
                                                 ("C", 150, 276), ("A/D", 278, 256)])
def test_fwd_plan_grows_past_48_kb_and_does_less_work(variant, in_size, out):
    """At the four full-size variant shapes the plan takes more than the
    48 KB the C++ planner was held to, and no more FMAs than that planner's
    square tile; B (up 2, down 4, 24 down taps), whose halo costs most, gets
    a non-square tile with at least 10% fewer."""
    up, down, ntu, ntd = SHIPPED_GEOMETRIES[variant]
    plan = k1.plan_fwd_tile(up, down, ntu, ntd, out, out)
    old = _fwd_48kb_fmas(up, down, ntu, ntd, out)
    assert plan["smem_bytes"] > 48 * 1024
    assert plan["fmas_per_plane"] <= old
    if variant == "B":
        assert plan["tile_y"] != plan["tile_x"]
        assert plan["fmas_per_plane"] <= 0.9 * old


def test_plan_object_hands_the_fwd_tile_to_the_entry_point():
    """``_Plan.fwd_tile`` gives the C entry point's eight integers (Ty, Tx,
    My, Mx, Ly, Lx, bytes, specialised) for the call's geometry and output
    size; an odd geometry asks for the generic kernel."""
    fu = design_lowpass_filter(12, cutoff=9.5, width=9.5, fs=76)
    x = torch.zeros((1, 2, 38, 38))
    plan = k1._Plan(x, fu, fu, 2, 2, (9, 8, 9, 8), np.sqrt(2), 0.2, 256.0, False)
    assert (plan.out_h, plan.out_w) == (36, 36)
    want = k1.plan_fwd_tile(2, 2, 12, 12, 36, 36)
    assert plan.fwd_tile() == (want["tile_y"], want["tile_x"], want["mid_y"], want["mid_x"],
                               want["in_y"], want["in_x"], want["smem_bytes"], 1)
    odd = k1._Plan(x, fu[:7], None, 3, 1, 0, np.sqrt(2), 0.2, None, False)
    assert odd.fwd_tile()[-1] == 0


@pytest.mark.parametrize("out_h,rows", [(38, 20), (54, 18), (36, 18), (7, 18),
                                        (84, 18), (150, 20), (278, 20)])
def test_k3_tile_rows_cover_the_output_with_least_idle_work(out_h, rows):
    """K3's pixel tile is 8 columns x 18 or 20 rows, whichever covers the
    output's rows with fewer rows to spare; the idle share follows."""
    assert k3.plan_tile_rows(out_h) == rows
    other = 38 - rows
    assert -(-out_h // rows) * rows <= -(-out_h // other) * other
    covered = -(-out_h // rows) * rows * -(-out_h // 8) * 8
    assert k3.tile_idle_share(out_h, out_h) == pytest.approx(1 - out_h ** 2 / covered)
    assert 0 <= k3.tile_idle_share(out_h, out_h) < 1


def test_k3_tile_idle_share_at_the_routed_shapes():
    """The int8 path's outputs (38^2, 54^2, 36^2) idle at most a tenth of
    the products; the 8 x 16 tile they replace idled 25%, 19% and 33%."""
    assert k3.tile_idle_share(38, 38) == pytest.approx(1 - 1444 / 1600)
    assert k3.tile_idle_share(54, 54) == pytest.approx(1 - 2916 / 3024)
    assert k3.tile_idle_share(36, 36) == pytest.approx(1 - 1296 / 1440)


def _jax_quantize(x, axis_eps):
    """The JAX package's quantizer formulas (conv_int8.py:258-262, :276-280)
    written out with jnp: the package has them inline in ``conv3x3_int8`` and
    exposes no function for them. So these tests hold the port against a
    copy of the reference's lines, integer for integer;
    tests/test_torch_int8.py holds the same plain versions against the
    package's ``conv3x3_int8`` itself, end to end."""
    xf = jnp.asarray(x)
    scale = jnp.maximum(jnp.max(jnp.abs(xf), axis=(1, 2, 3)), axis_eps) / 127.0
    return (np.asarray(jnp.clip(jnp.round(xf / scale[:, None, None, None]), -127, 127)),
            np.asarray(scale))


@pytest.mark.parametrize("i,h,p", [(48, 20, 1), (40, 9, 2), (91, 12, 0), (64, 13, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_activation_quantizer_plain_matches_jax(i, h, p, dtype):
    """The plain version of the activation quantizer kernel (x_scale and the
    packed int8 NHWC tensor) against the JAX package's quantization
    (afcm_tpu/ops/pallas/conv_int8.py:258-262) of the same numbers, exact;
    an all-zero sample takes the scale floor 1e-8 / 127 and quantizes to 0."""
    rng = np.random.RandomState(i + h)
    x = rng.randn(3, i, h, h).astype(np.float32)
    x[1] = 0
    x[2, 0, 0, :5] = [0.5, 1.5, 2.5, -0.5, 127.0]
    x[2] = np.clip(x[2], -127, 127)                    # scale 1: the first are ties
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    x = xt.float().numpy()                             # what both quantize
    packed, x_scale = k3.quantize_pack_activations_plain(xt, p)
    want_q, want_scale = _jax_quantize(x, 1e-8)
    np.testing.assert_array_equal(x_scale.numpy(), want_scale)
    assert x_scale[1] == np.float32(1e-8) / np.float32(127.0)
    ip = -(-i // 32) * 32
    assert packed.dtype == torch.int8 and packed.is_contiguous()
    assert packed.shape == (3, h + 2 * p, h + 2 * p, ip)
    inner = packed[:, p:p + h, p:p + h, :i].permute(0, 3, 1, 2).numpy()
    np.testing.assert_array_equal(inner, want_q.astype(np.int8))
    assert int(packed.abs().sum()) == int(np.abs(want_q).sum())   # halo and pad are zero
    assert int(packed[1].abs().sum()) == 0
    if dtype == "float32":
        assert inner[2, 0, 0, :4].tolist() == [0, 2, 2, 0]


@pytest.mark.parametrize("o,i", [(40, 48), (96, 40), (160, 91)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_quantizer_plain_matches_jax(o, i, dtype):
    """The plain version of the weight quantizer kernel (w_scale and the
    packed int8 tensor, [9, O', I'] once its tiling is undone) against the JAX package's per-channel
    quantization (conv_int8.py:276-280), exact; an all-zero channel takes
    the floor 1e-12 / 127."""
    rng = np.random.RandomState(o)
    w = (rng.randn(o, i, 3, 3) / np.sqrt(9 * i)).astype(np.float32)
    w[3] = 0
    wt = torch.from_numpy(w).to(getattr(torch, dtype))
    w = wt.float().numpy()
    packed, w_scale = k3.quantize_pack_weights_plain(wt)
    want_q, want_scale = _jax_quantize(w, 1e-12)
    np.testing.assert_array_equal(w_scale.numpy(), want_scale)
    op, ip = -(-o // 128) * 128, -(-i // 32) * 32
    assert packed.dtype == torch.int8 and packed.is_contiguous()
    assert packed.shape == (op // 64, ip // 32, 9, 2, 64, 16)
    flat = k3.unpack_weights(packed)
    taps = flat.reshape(3, 3, op, ip).permute(2, 3, 0, 1)[:o, :i].numpy()
    np.testing.assert_array_equal(taps, want_q.astype(np.int8))
    assert int(packed.abs().sum()) == int(np.abs(want_q).sum())
    assert int(flat[:, 3].abs().sum()) == 0


def test_quantizer_dispatch_takes_the_plain_version_on_the_cpu(monkeypatch):
    """A CPU tensor goes through ``conv3x3_int8``'s one dispatch to the plain
    version and launches nothing; the kernels' wrappers raise on one."""
    def no_kernel(*args):
        raise AssertionError("a CPU tensor reached a kernel")
    monkeypatch.setattr(k3, "quantize_pack_activations_cuda", no_kernel)
    monkeypatch.setattr(k3, "quantize_pack_weights_cuda", no_kernel)
    counts = (k3.quantize_launches, k3.weight_quantize_launches, k3.launches)
    x, w = torch.randn(2, 32, 8, 8), torch.randn(32, 32, 3, 3)
    got = k3.conv3x3_int8(x, w, 1)
    xp, xs = k3.quantize_pack_activations_plain(x, 1)
    wp, ws = k3.quantize_pack_weights_plain(w)
    assert counts == (k3.quantize_launches, k3.weight_quantize_launches, k3.launches)
    # the packed operands hold the conv the plain version computes
    taps = k3.unpack_weights(wp).reshape(3, 3, 128, 32).permute(2, 3, 0, 1)[:32].double()
    acc = torch.nn.functional.conv2d(xp.permute(0, 3, 1, 2).double(), taps).to(torch.int32)
    want = (acc.float() * k3.dequant_scale(xs, ws)[:, :, None, None]).to(torch.bfloat16)
    assert torch.equal(got, want)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA"):
        k3.quantize_pack_activations_cuda(x, 1)
    with pytest.raises(ValueError, match="CUDA"):
        k3.quantize_pack_weights_cuda(w)


# The bulk copy (K5a, K6a, K6b; ops/cuda/probe_stream.py:plan_copy). A case:
# bytes, block bytes (None: the flat copy, whose CTAs share the span), x's
# offset past a 16-byte boundary.
COPY_PLAN_CASES = {
    "copy3d_cb8_full": (8192 * 276 * 276 * 2, 8 * 276 * 276 * 2, 0),
    "copy3d_cb1_odd_offset": (5 * 7 * 9 * 2, 7 * 9 * 2, 2),
    "copy3d_rows_of_552_bytes_offset_6": (8 * 9 * 276 * 2, 2 * 9 * 276 * 2, 6),
    "copy2d_ragged_last_cta": (31 * 72 * 2, 8 * 72 * 2, 0),
    "copy2d_ragged_last_cta_offset_14": (31 * 72 * 2, 8 * 72 * 2, 14),
    "copy2d_br8192_full": (1218816 * 512 * 2, 8192 * 512 * 2, 0),
    "span_under_16_bytes": (10, 10, 4),
    "spans_under_16_bytes_a_cta": (9 * 3 * 2, 2 * 3 * 2, 8),
    "span_not_a_multiple_of_a_stage": (3 * ps.FLAT_RING[1] + 1234, None, 2),
    "block_not_a_multiple_of_a_stage": (5 * ps.BLOCK_RING[1] + 98, 2 * ps.BLOCK_RING[1] + 34, 6),
    "block_beyond_the_ring": (4 * 64 * 276 * 2, 4 * 64 * 276 * 2, 10),
    "flat_fir_full": (2048 * 276 * 276 * 2, None, 0),
    "flat_odd_offset": (2048 * 276 * 276 * 2 + 6, None, 2),
}


@pytest.mark.parametrize("case", list(COPY_PLAN_CASES))
def test_copy_plan_tiles_the_span(case):
    """A block plan's CTAs tile the span in order, every one but the last a
    whole block; a shared plan is one span of pieces for up to one CTA an
    SM. Each CTA's head and tail beside its 16-byte body follow from its
    bytes and x's offset, as the kernel cuts them (the card's tests hold the
    copies bit-equal at such offsets)."""
    nbytes, block, offset = COPY_PLAN_CASES[case]
    plan = ps.plan_copy(nbytes, block)
    assert plan.shared == (block is None) and plan.nbytes == nbytes
    if plan.shared:
        assert plan.block_bytes == nbytes
        assert plan.ctas == max(1, min(132, -(-nbytes // plan.stage_bytes)))
        starts = [0]
    else:
        assert plan.block_bytes == block and plan.ctas == -(-nbytes // block)
        assert 0 < nbytes - (plan.ctas - 1) * block <= block
        starts = sorted({0, block, (plan.ctas - 1) * block} & set(range(0, nbytes, block)))
    for start in starts:
        length = min(plan.block_bytes, nbytes - start)
        head = min(-(offset + start) % 16, length)
        body = (length - head) // 16 * 16
        assert head < 16 and length - head - body < 16 and head % 2 == 0
        assert body == 0 or (offset + start + head) % 16 == 0


@pytest.mark.parametrize("kernel,blocks,want_ctas", [
    ("copy3d", {4: 4 * 276 * 276 * 2, 8: 8 * 276 * 276 * 2, 16: 16 * 276 * 276 * 2},
     {4: 2048, 8: 1024, 16: 512}),
    ("copy2d", {br: br * 512 * 2 for br in (2048, 4096, 8192)}, {2048: 596, 4096: 298, 8192: 149}),
])
def test_copy_plan_keeps_the_tpu_grid(kernel, blocks, want_ctas):
    """copy3d and copy2d at the probe's full size ([8192, 276, 276] bf16 and
    its [1218816, 512] view): one CTA per block of cb planes or br rows."""
    nbytes = 8192 * 276 * 276 * 2
    for key, block in blocks.items():
        plan = ps.plan_copy(nbytes, block)
        assert plan.ctas == want_ctas[key] and plan.block_bytes == block and not plan.shared
        assert (plan.stages, plan.stage_bytes) == ps.BLOCK_RING


def test_flat_copy_plan_is_a_persistent_grid():
    """K5a: one CTA on each SM sharing the span, fewer for a span of fewer
    pieces than SMs, through the flat ring."""
    nbytes = 2048 * 276 * 276 * 2
    plan = ps.plan_copy(nbytes, None, sms=132)
    assert (plan.ctas, plan.block_bytes, plan.shared) == (132, nbytes, True)
    assert (plan.stages, plan.stage_bytes) == ps.FLAT_RING
    assert ps.plan_copy(nbytes, None, sms=114).ctas == 114
    assert ps.plan_copy(5 * ps.FLAT_RING[1] + 2, None, sms=132).ctas == 6
    assert ps.plan_copy(10, None).ctas == 1


def test_copy_rings_fit_the_sm_and_fill_the_card():
    """K6's ring (6 x 32 KB) holds one CTA an SM with five 32 KB loads in
    flight, so even 30 CTAs keep 4.9 MB in flight; K5a's (4 x 16 KB) would
    fit three CTAs an SM, and its 132 keep 6.5 MB in flight. The card moves
    3.35 MB a microsecond. An H100 SM has 228 KB of shared memory, of which
    each CTA reserves 1 KB beside its ring and the kernel's 8 barriers."""
    def ctas_per_sm(ring):
        return 233472 // (ring[0] * ring[1] + 8 * ps.RING_STAGES_MAX + 1024)

    assert ps.BLOCK_RING == (6, 32768) and ps.FLAT_RING == (4, 16384)
    assert ctas_per_sm(ps.BLOCK_RING) == 1 and ctas_per_sm(ps.FLAT_RING) == 3
    assert ps.BLOCK_RING[0] * ps.BLOCK_RING[1] <= ps.CTA_SHARED_MAX
    assert 30 * (ps.BLOCK_RING[0] - 1) * ps.BLOCK_RING[1] >= 3.35e12 * 1e-6
    assert 132 * (ps.FLAT_RING[0] - 1) * ps.FLAT_RING[1] >= 3.35e12 * 1e-6


def test_copy_ring_limits_match_the_kernel_source():
    src = open(os.path.join(os.path.dirname(ps.__file__), "..", "..", "csrc",
                            "probe_stream.cu")).read()
    assert int(re.search(r"#define AFCM_PS_RING_MAX (\d+)", src).group(1)) == ps.RING_STAGES_MAX
    assert int(re.search(r"#define AFCM_PS_SMEM_MAX (\d+)", src).group(1)) == ps.CTA_SHARED_MAX


@pytest.mark.parametrize("args", [dict(nbytes=9), dict(nbytes=0), dict(nbytes=64, block_bytes=3),
                                  dict(nbytes=64, ring=(1, 1024)), dict(nbytes=64, ring=(9, 1024)),
                                  dict(nbytes=64, ring=(4, 24)),
                                  dict(nbytes=64, ring=(8, 32768))])
def test_copy_plan_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError, match="bulk copy"):
        ps.plan_copy(**args)


@pytest.mark.parametrize("elems_off", range(8))
def test_aligned_output_shares_the_inputs_offset(elems_off):
    """y starts where x starts modulo 16 bytes, for every bf16 offset, and
    is a contiguous tensor of x's shape that does not overlap x."""
    buf = torch.zeros(200, dtype=torch.bfloat16)
    x = buf[elems_off:elems_off + 96].view(4, 24)
    x.copy_(torch.arange(96, dtype=torch.bfloat16).view(4, 24))
    y = ps.empty_like_aligned(x)
    assert (y.data_ptr() - x.data_ptr()) % 16 == 0
    assert y.shape == x.shape and y.dtype == x.dtype and y.is_contiguous()
    assert y.untyped_storage().data_ptr() != buf.untyped_storage().data_ptr()
    assert torch.equal(ps.stream_copy(x), x) and torch.equal(ps.copy2d(x, 3), x)


# ---------------------------------------------------------------- K8, K9

SM_SHARED = 233472          # an H100 SM's shared memory; a CTA reserves 1 KB
# (offsets, bytes of K, bytes an output value) of the probes' calls and the
# small test shape's
PROBE_TAPS = {"k8": ([0], 512, 4), "k9_dot1": (p8.tap_offsets("dot1", 160), 384, 2),
              "k9_aligned": (p8.tap_offsets("aligned", 160), 384, 2),
              "k9_slices": (p8.tap_offsets("slices", 160), 384, 2),
              "small_slices": (p8.tap_offsets("slices", 21), 64, 2)}


@pytest.mark.parametrize("layout", ["raw_tma", "raw_async", "k_major"])
@pytest.mark.parametrize("case", list(PROBE_TAPS))
def test_taps_plan_fits_one_block_and_holds_the_ring(case, layout):
    """At the probes' taps every tap is in one group (x staged once per K
    step for all taps), and the ring, its raw buffers and the staged int32
    tile fit the 227 KB of one block with the kernel's static barriers (one
    CTA an SM: 384 threads of up to 168 registers take the register file):
    the most K slices a step (4, 2, 1, dividing K) that keep three stages
    (one slice: two), then the most stages (up to 8). Raw x: tensor-map
    boxes of at most 256 bytes a row that cover the span in 16-byte
    multiples, or cp.async rows long enough for a start up to 15 bytes off
    plus a 4-byte funnel shift; K-major x: boxes of at most 256 rows of
    8-row multiples that the span fills."""
    offsets, i, out_bytes = PROBE_TAPS[case]
    raw = layout != "k_major"
    pl = p8.plan_taps(offsets, i, raw, out_bytes, tma_ok=layout == "raw_tma")
    assert pl.groups == 1 and pl.tap == tuple(sorted(range(len(offsets)),
                                                     key=lambda t: offsets[t]))
    spread = max(offsets) - min(offsets)
    assert pl.a_bytes == 4096 * len(offsets) and pl.slice_bytes == pl.a_bytes + 32 * pl.span
    assert pl.stage_bytes == pl.ksub * pl.slice_bytes and i % (32 * pl.ksub) == 0
    assert pl.slice_bytes % 256 == 0            # the swizzled weights' atoms
    assert pl.epi_bytes == (64 * (256 * 4 + 16) if out_bytes == 4 else 0)
    raw_bytes = pl.xboxes * 32 * pl.ksub * pl.xw if raw else 0
    assert pl.smem == pl.stages * pl.stage_bytes + pl.raws * raw_bytes + pl.epi_bytes + 1024
    assert pl.smem + 4 * 8 * p8.MAX_STAGES <= 232448
    assert (3 if pl.ksub > 1 else 2) <= pl.stages <= p8.MAX_STAGES
    assert pl.raws == 0 if not raw else pl.raws in (pl.stages, 2)
    fits = lambda stages, raws, ksub=pl.ksub: (  # noqa: E731
        stages * ksub * pl.slice_bytes + raws * pl.xboxes * 32 * ksub * pl.xw * raw
        + pl.epi_bytes + 1024 <= p8.SMEM_BUDGET)
    if not raw or pl.raws == pl.stages:         # the most stages (with as many raw buffers)
        assert pl.stages == p8.MAX_STAGES or not fits(pl.stages + 1, pl.stages + 1)
    else:                                       # no ring of three with as many fits
        assert not fits(3 if pl.ksub > 1 else 2, 3 if pl.ksub > 1 else 2)
    if pl.ksub < 4 and i % (64 * pl.ksub) == 0:     # twice the slices keep no ring of three
        assert not fits(3, 2 * raw, 2 * pl.ksub)
    assert pl.x_tma == (layout == "raw_tma")
    if layout == "raw_tma":
        assert pl.span == -(-(256 + spread) // 8) * 8
        assert pl.xw % 16 == 0 and pl.xw <= 256 and pl.xboxes * pl.xw >= pl.span
        assert (pl.xboxes - 1) * pl.xw < pl.span and 32 * pl.ksub <= 256
    elif raw:
        assert (pl.xboxes, pl.xw) == (1, -(-(pl.span + 32) // 16) * 16)
        assert pl.xw >= pl.span + 15 + 4
    else:
        assert pl.span == pl.xboxes * pl.xw >= 256 + spread
        assert pl.xw % 8 == 0 and pl.xw <= 256 and (pl.xboxes - 1) * pl.xw < 256 + spread
    assert pl.b_sw32 == (not raw and all(o % 8 == 0 for o in pl.off))


def test_taps_plan_at_the_probes_shapes():
    """K9 (slices, wp 160, bf16 out from the registers): one slice a step,
    spans of 584 rows (256 + 322) in three boxes of 208 bytes, 54 KB
    stages and 20 KB raw buffers, a ring of 3, 222 KB. K8 (one tap, int32,
    K 512): two slices a step as x comes raw (24 KB stages, 16 KB raw
    buffers, a ring of 4 beside the 65 KB staged tile), four as it comes
    K-major (48 KB stages, a ring of 3). K9's one tap (bf16): four slices,
    3 stages and 2 raw buffers of 32 KB."""
    k9 = p8.plan_taps(p8.tap_offsets("slices", 160), 384, True, 2)
    assert (k9.span, k9.ksub, k9.xboxes, k9.xw, k9.x_tma, k9.stage_bytes, k9.stages, k9.raws,
            k9.epi_bytes, k9.smem) == (584, 1, 3, 208, 1, 55552, 3, 3, 0, 227584)
    k8 = p8.plan_taps([0], 512, True, 4)
    assert (k8.span, k8.ksub, k8.xboxes, k8.xw, k8.x_tma, k8.stage_bytes, k8.stages, k8.raws,
            k8.epi_bytes, k8.smem) == (256, 2, 1, 256, 1, 24576, 4, 4, 66560, 231424)
    dot1 = p8.plan_taps([0], 384, True, 2)
    assert (dot1.ksub, dot1.stages, dot1.raws, dot1.smem) == (4, 3, 2, 214016)
    kli = p8.plan_taps([0], 512, False, 4)
    assert (kli.ksub, kli.xboxes, kli.xw, kli.b_sw32, kli.stages, kli.smem) == \
        (4, 1, 256, 1, 3, 215040)


def test_taps_plan_stages_far_taps_one_a_step():
    """Offsets whose spread leaves no ring of two stages in 227 KB are
    staged one tap a step: 9 groups of span 256, each based at its tap's
    offset; their starts off 16 bytes take raw x by cp.async."""
    offsets = [0, 1, 1500, 2999, 3001, 17, 4000, 4007, 2]
    pl = p8.plan_taps(offsets, 64, True, 4)
    assert pl.groups == 9 and pl.span == 256 and pl.off == (0,) * 9
    assert pl.base == tuple(sorted(offsets)) and pl.a_bytes == 4096 and pl.x_tma == 0
    assert pl.smem + 4 * 8 * p8.MAX_STAGES <= 232448
    aligned = p8.plan_taps([0, 16, 1504, 2992, 3008, 32, 4000, 4016, 48], 64, True, 4)
    assert aligned.groups == 9 and aligned.x_tma == 1


@pytest.mark.parametrize("offsets,i", [([], 64), ([0] * 10, 64), ([-1, 0], 64), ([0], 96)])
def test_taps_plan_refuses_what_the_kernel_does_not_take(offsets, i):
    with pytest.raises(ValueError, match="taps_matmul plan"):
        p8.plan_taps(offsets, i, True, 4)


def test_taps_plan_limits_match_the_kernel_source():
    src = open(os.path.join(os.path.dirname(p8.__file__), "..", "..", "csrc",
                            "probe_int8.cu")).read()
    defines = dict(re.findall(r"#define (AFCM_P8_\w+) (\d+)", src))
    assert int(defines["AFCM_P8_BN"]) == p8.TILE_N
    assert int(defines["AFCM_P8_MAX_TAPS"]) == p8.MAX_TAPS
    assert int(defines["AFCM_P8_MAX_STAGES"]) == p8.MAX_STAGES
    assert int(defines["AFCM_P8_BOX_MAX"]) == p8.BOX_MAX
    assert "(232448 - 4 * 8 * AFCM_P8_MAX_STAGES)" in src


# slice_sum_kernel (K9 sliceonly): (S, O, I, P, N) of the probe, its small
# size, and edge cases: I > O, I not a multiple of the unit, a unit
# straddling I, P % 16 == 8, rows too wide for three stages, for two CTAs
# an SM, for units of 8 rows.
SLICE_SHAPES = {"probe": (208, 512, 384, 2304, 1920), "probe_small": (2, 128, 64, 256, 128),
                "i_greater_than_o": (2, 24, 40, 96, 64), "i_of_13": (3, 16, 13, 80, 64),
                "straddling_i": (2, 20, 12, 144, 128), "p_mod_16_is_8": (3, 24, 24, 456, 128),
                "far_apart": (2, 16, 12, 4280, 256), "wide": (1, 8, 8, 14000, 6000),
                "widest": (1, 4, 4, 30000, 20000)}


def _slice_units(rows, s, o, i):
    """slice_sum_kernel's units in its order (csrc/probe_int8.cu), as (step,
    first row, end of the summed rows, end of the rows): rows below min(O,
    I) are summed, the rest zero; CTA b of a grid of g takes units b, b + g,
    ..."""
    return [(step, o0, max(o0, min(o0 + rows, o, i)), min(o0 + rows, o))
            for step in range(s) for o0 in range(0, o, rows)]


def _slice_fits(rows, ctas, stages, p, n):
    smem = stages * (-(-(rows * p + 32) // 128) * 128) + 4 * rows * n + 4096 + 128
    return smem + p8.SLICE_STATIC <= min(232448, SM_SHARED // ctas - 1024)


@pytest.mark.parametrize("case", list(SLICE_SHAPES))
def test_slice_plan_fits_the_sm_and_covers_every_row(case):
    """The x ring, two staging buffers and the zero rows fit the SM's
    shared memory ctas times, 1 KB a CTA kept for the system; an x stage
    holds a unit's rows, a 16-byte realignment and the one word the last
    column's tap reads past them; the plan is the first that fits of the
    most rows a unit, CTAs an SM and stages, in that order. Every row of
    every step is in one unit, summed below min(O, I) and zero above, and
    the persistent grid gives each CTA its share of units within one."""
    s, o, i, p, n = SLICE_SHAPES[case]
    pl = p8.plan_slice_sum(o, i, p, n)
    assert pl.in_bytes % 128 == 0 and pl.in_bytes >= pl.rows * p + 8 + 4 + 8
    assert pl.out_bytes == pl.rows * n * 2 and pl.out_bytes % 16 == 0
    assert pl.smem == pl.stages * pl.in_bytes + 2 * pl.out_bytes + p8.SLICE_ZERO + 128
    assert pl.smem + p8.SLICE_STATIC <= 232448
    assert pl.ctas * (pl.smem + p8.SLICE_STATIC + 1024) <= SM_SHARED
    assert _slice_fits(pl.rows, pl.ctas, pl.stages, p, n)
    if pl.rows < 8:
        assert not any(_slice_fits(2 * pl.rows, c, t, p, n) for c in (1, 2) for t in (2, 3))
    if pl.ctas == 1:
        assert not _slice_fits(pl.rows, 2, 2, p, n)
    if pl.stages == 2:
        assert not _slice_fits(pl.rows, pl.ctas, 3, p, n)
    units = _slice_units(pl.rows, s, o, i)
    seen = np.zeros((s, o), dtype=int)
    for step, o0, l1, o1 in units:
        assert o0 <= l1 <= o1 <= o0 + pl.rows and o1 <= o
        assert l1 == max(o0, min(o1, i))
        seen[step, o0:o1] += 1
    assert (seen == 1).all()
    grid = min(len(units), 132 * pl.ctas)
    shares = [len(range(b, len(units), grid)) for b in range(grid)]
    assert sum(shares) == len(units) and max(shares) - min(shares) <= 1


def test_slice_plan_at_the_probes_shape():
    """w9 [9,512,384], x [208,384,2304] -> [208,512,1920]: units of 8 rows
    (18 KB of x, 30 KB of bf16 out), two CTAs an SM of 100.4 KB each with a
    two-stage ring (three do not fit beside two staging buffers); 13,312
    units, 9,984 of them live, on 264 CTAs."""
    pl = p8.plan_slice_sum(512, 384, 2304, 1920)
    assert (pl.rows, pl.stages, pl.ctas, pl.in_bytes, pl.out_bytes, pl.smem) == \
        (8, 2, 2, 18560, 30720, 102784)
    units = _slice_units(pl.rows, 208, 512, 384)
    assert len(units) == 13312 and sum(o0 < l1 for _, o0, l1, _ in units) == 9984


@pytest.mark.parametrize("o,i,p,n", [(0, 8, 64, 64), (8, 0, 64, 64), (8, 8, 64, 60),
                                     (8, 8, 68, 64), (8, 8, 56, 64), (8, 8, 64, 0),
                                     (8, 8, 120000, 60000)])
def test_slice_plan_refuses_what_the_kernel_does_not_take(o, i, p, n):
    with pytest.raises(ValueError, match="slice_sum plan"):
        p8.plan_slice_sum(o, i, p, n)


def test_slice_plan_limits_match_the_kernel_source():
    src = open(os.path.join(os.path.dirname(p8.__file__), "..", "..", "csrc",
                            "probe_int8.cu")).read()
    defines = dict(re.findall(r"#define (AFCM_SL_\w+) (\d+)", src))
    assert int(defines["AFCM_SL_ZERO"]) == p8.SLICE_ZERO
    assert int(defines["AFCM_SL_SMEM_SM"]) == p8.SLICE_SMEM_SM == SM_SHARED
    assert 2 * 8 * int(defines["AFCM_SL_MAX_STAGES"]) == p8.SLICE_STATIC
    assert "#define AFCM_SL_STATIC (2 * 8 * AFCM_SL_MAX_STAGES)" in src


@pytest.mark.parametrize("mode", ["dot1", "aligned", "slices"])
def test_taps_plain_is_the_probes_plain_versions(mode):
    """The shared product's plain version (raw and K-major x, int32 and bf16)
    against K8's and K9's own plain versions, exactly."""
    rng = np.random.RandomState(11)
    w9 = torch.from_numpy(rng.randint(-127, 127, (9, 16, 32)).astype(np.int8))
    x = torch.from_numpy(rng.randint(-127, 127, (2, 32, 40)).astype(np.int8))
    offsets = p8.tap_offsets(mode, 8)
    got = p8.taps_matmul_int8(w9, x, offsets, 16, out_dtype=torch.bfloat16)
    assert torch.equal(got, p8.nine_tap_int8_plain(w9, x, mode, 16, 8))
    kli = p8.taps_matmul_int8(w9, x.transpose(1, 2).contiguous(), offsets, 16, raw=False)
    assert torch.equal(p8.to_bf16(kli), got)
    b = x[:, :, :24].contiguous()
    assert torch.equal(p8.taps_matmul_int8(w9[:1], b, [0], 24),
                       p8.stacked_matmul_int8_plain(w9[0], b))


# ---------------------------------------------------------------- K7

@pytest.mark.parametrize("c_out,win_h,win_w", [
    (128, 39, 39), (362, 48, 48), (256, 29, 29), (128, 43, 43), (8, 64, 128), (16, 64, 128),
    (7, 9, 7), (1, 39, 39), (6, 50, 150), (5, 1, 1), (1, 300, 300)])
def test_window_plan_groups_channels_by_four(c_out, win_h, win_w):
    """A CTA takes a multiple of 4 channels (at least 4), the most whose
    output fits one chunk, never more than c_out rounded up to 4; a chunk is
    a multiple of 4 values within 48 KB and holds the CTA's span or is full."""
    group, chunk = ps.plan_windows(c_out, win_h, win_w)
    area = win_h * win_w
    assert group >= 4 and group % 4 == 0 and group <= -(-c_out // 4) * 4
    assert group == 4 or group * area <= ps.WINDOW_CHUNK
    assert group == -(-c_out // 4) * 4 or (group + 4) * area > ps.WINDOW_CHUNK
    assert chunk % 4 == 0 and 4 <= chunk <= ps.WINDOW_CHUNK
    assert chunk * 4 <= ps.CTA_SHARED_MAX
    assert chunk == min(ps.WINDOW_CHUNK, -(-group * area // 4) * 4)


def test_window_plan_at_k1s_variants():
    """K1's windows (variants A-D): 8, 4, 12 and 4 channels a CTA, one chunk
    each (48.7, 36.9, 40.4 and 29.6 KB), several CTAs an SM."""
    plans = [ps.plan_windows(c, s, s) for c, s in ((128, 39), (362, 48), (256, 29), (128, 43))]
    assert plans == [(8, 12168), (4, 9216), (12, 10092), (4, 7396)]
    assert all(SM_SHARED // (4 * chunk + 1024) >= 4 for _, chunk in plans)
