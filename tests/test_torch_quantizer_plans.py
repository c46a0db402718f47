"""The plans of the int8 conv's quantizer kernels (``csrc/quantize_int8.cu``)
as ``afcm_tpu_torch/ops/cuda/conv_int8.py`` mirrors them, on the CPU.

The kernels run only on the card. There tests/test_torch_cuda.py holds them
bit for bit to their plain versions, every byte of an output that was never
cleared, and holds the C side's plans (``afcm_quantize_*_plan``) equal to
the mirrors. What this file holds is a model of the kernels' indexing,
written here from the source at every shape the card does not reach: the
activation kernel's tickets (``item_of``: every work item once, every amax
tile of a sample before any of its quantize tiles, the order that makes the
kernel free of deadlock), the bytes its tiles read and write
(``amax_tile``, ``halo_pixel``, ``quantize_tile``: every element of a
sample read by one amax tile, every run of 8 channels of the packed output
written by exactly one store, each store's source pixel), the weight
kernel's stores, and the shared memory of both. The stores are replayed
with the plain version's quantized integers and the result must equal the
plain version's packed tensors, so a store that went to the wrong place
would show. The JAX package's quantization is the plain versions' reference
(tests/test_torch_plans.py). Inputs are made with numpy from a seed.
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from afcm_tpu_torch.ops.cuda import conv_int8 as k3  # noqa: E402

torch.set_num_threads(1)

# (n, i, h, p, itemsize, address % 16): the CMSR path's three inputs (bf16),
# the CoModGAN path's three (float32), and the edges: one sample, I = 200
# (I' = 224 > I, a last group of 32 channels), p = 0 / 1 / 2, H = 4, a
# plane that is no multiple of 16 bytes, x 2 bytes off 16.
ACTIVATION_CASES = [
    (16, 512, 36, 2, 2, 0), (16, 512, 52, 2, 2, 0), (16, 512, 38, 0, 2, 0),
    (16, 512, 10, 0, 4, 0), (16, 512, 18, 0, 4, 0), (16, 512, 34, 0, 4, 0),
    (1, 512, 36, 2, 2, 0), (3, 200, 9, 1, 2, 0), (2, 200, 4, 2, 4, 0),
    (2, 91, 41, 1, 4, 8), (64, 512, 36, 2, 2, 0), (3, 48, 38, 2, 2, 2),
    (3, 33, 7, 0, 2, 0), (2, 40, 4, 1, 2, 4),
]
WEIGHT_CASES = [(512, 512, 4, 0), (256, 512, 4, 0), (512, 512, 2, 0), (200, 33, 4, 0),
                (200, 200, 2, 0), (96, 40, 4, 8), (40, 48, 2, 2)]


def activation_items(plan):
    """Every ticket's work item in ticket order, as ``item_of`` maps it:
    int arrays (kind: 0 amax, 1 quantize; sample; tile)."""
    t = np.arange(plan.tickets, dtype=np.int64)
    kind, n, tile = np.zeros_like(t), np.zeros_like(t), np.zeros_like(t)
    first = plan.lag * plan.ta
    head = t < first
    n[head], tile[head] = t[head] // plan.ta, t[head] % plan.ta
    step = plan.ta + plan.tq
    u = t - first
    both = (~head) & (u < (plan.n - plan.lag) * step)
    k, r = u[both] // step, u[both] % step
    kind[both] = (r < plan.tq).astype(np.int64)
    n[both] = np.where(r < plan.tq, k, k + plan.lag)
    tile[both] = np.where(r < plan.tq, r, r - plan.tq)
    tail = (~head) & ~both
    v = u[tail] - (plan.n - plan.lag) * step
    kind[tail], n[tail], tile[tail] = 1, plan.n - plan.lag + v // plan.tq, v % plan.tq
    return kind, n, tile


def amax_tile_range(plan, tile):
    """The elements ``[e0, e1)`` of its sample that amax tile ``tile`` reads."""
    e0 = tile * plan.a_elems
    return e0, min(e0 + plan.a_elems, plan.count)


def halo_pixel(plan, idx):
    """``halo_pixel``: the padded plane's pixel of each zero pixel ``idx``."""
    p, h, w, wp = plan.p, plan.h, plan.w, plan.w + 2 * plan.p
    top, side = p * wp, h * 2 * p
    out = np.array(idx, dtype=np.int64)
    mid = (idx >= top) & (idx < top + side)
    j = idx[mid] - top
    s = j % max(2 * p, 1)
    out[mid] = (p + j // max(2 * p, 1)) * wp + np.where(s < p, s, w + s)
    low = idx >= top + side
    out[low] = (p + h) * wp + idx[low] - top - side
    return out


def quantize_tile_writes(plan, tile):
    """The stores quantize tile ``tile`` makes in its sample's ``[H+2p,
    W+2p, I']`` output, as ``quantize_tile`` makes them: its halo share
    (zeros, 16 bytes a store), then each lane's V pixels of its 8 channels
    (8 bytes a store). Int arrays (pixel of the padded plane, first
    channel, channels, source pixel ``h * W + w`` of x or -1 for a zero
    pixel)."""
    chunk, group = tile % plan.chunks, tile // plan.chunks
    wp = plan.w + 2 * plan.p
    h0 = chunk * plan.halo_share
    cnt = max(0, min(plan.halo_share, plan.halo - h0))
    e = np.arange(cnt * 4)
    c = group * k3._Q8_GROUP + (e & 3) * 16
    keep = c < plan.ip
    pix, chan = [halo_pixel(plan, h0 + (e[keep] >> 2))], [c[keep]]
    width, src = [np.full(int(keep.sum()), 16)], [np.full(int(keep.sum()), -1)]
    tid = np.arange(k3._Q8_THREADS)
    warp, lane = tid >> 5, tid & 31
    c = group * k3._Q8_GROUP + (lane & 7) * 8
    q0 = ((chunk * k3._Q8_WARPS + warp) * 4 + (lane >> 3)) * plan.vec
    keep = (c < plan.ip) & (q0 < plan.h * plan.w)
    for v in range(plan.vec):
        q = q0[keep] + v
        pix.append((q // plan.w + plan.p) * wp + q % plan.w + plan.p)
        chan.append(c[keep])
        width.append(np.full(len(q), 8))
        src.append(q)
    return tuple(np.concatenate(a) for a in (pix, chan, width, src))


def weight_cta_writes(plan, cta):
    """The 16-byte stores CTA ``cta`` (output channel ``cta``) of the weight
    kernel makes, as its loop makes them: int arrays (output channel, first
    input channel, tap)."""
    e = np.arange((plan.ip // 16) * 9)
    return np.full(len(e), cta), (e // 9) * 16, e % 9


def _case_id(case):
    return "x".join(str(v) for v in case)


def test_quantizer_plan_constants_match_the_source():
    """The Python mirror's constants are the ones the kernels are built with."""
    src = open(os.path.join(os.path.dirname(k3.__file__), "..", "..", "csrc",
                            "quantize_int8.cu")).read()
    defines = {k: int(v) for k, v in re.findall(r"#define (AFCM_Q8_\w+) (\d+)", src)}
    assert defines == {"AFCM_Q8_THREADS": k3._Q8_THREADS,
                       "AFCM_Q8_CTAS_PER_SM": k3._Q8_CTAS_PER_SM,
                       "AFCM_Q8_GROUP": k3._Q8_GROUP, "AFCM_Q8_A_VECS": k3._Q8_A_VECS}
    assert int(re.search(r"constexpr int SMEM_LIMIT = (\d+);", src).group(1)) == k3.SMEM_LIMIT
    assert int(re.search(r"constexpr int W_BAR_BYTES = (\d+);", src).group(1)) == k3._Q8_W_BAR


@pytest.mark.parametrize("case", ACTIVATION_CASES, ids=_case_id)
def test_activation_tickets_take_amax_before_quantize(case):
    """Every (kind, sample, tile) has exactly one ticket, and every A(n)
    ticket comes before every Q(n) ticket (a Q tile waits only on smaller
    tickets: no deadlock), with A(n + L) never before Q(n)."""
    n, i, h, p, itemsize, address = case
    plan = k3.plan_quantize_activations(n, i, h, h, p, itemsize, address)
    kind, sample, tile = activation_items(plan)
    assert len(kind) == plan.tickets == n * (plan.ta + plan.tq)
    assert 1 <= plan.lag <= n and 1 <= plan.grid <= k3._Q8_CTAS_PER_SM * k3.H100_SMS
    keys = (kind * n + sample) * max(plan.ta, plan.tq) + tile
    assert len(np.unique(keys)) == len(keys)
    for kd, limit in ((0, plan.ta), (1, plan.tq)):
        assert np.bincount(sample[kind == kd], minlength=n).tolist() == [limit] * n
        assert tile[kind == kd].max() < limit
    t = np.arange(plan.tickets)
    for s in range(n):
        last_a = t[(kind == 0) & (sample == s)].max()
        assert last_a < t[(kind == 1) & (sample == s)].min()
        if s + plan.lag < n:       # A(n + L) follows Q(n)'s tickets
            assert t[(kind == 0) & (sample == s + plan.lag)].min() > \
                t[(kind == 1) & (sample == s)].max()


@pytest.mark.parametrize("case", ACTIVATION_CASES, ids=_case_id)
def test_activation_tiles_read_and_write_every_byte_once(case):
    """The amax tiles of a sample read each of its elements once; the
    quantize tiles' stores cover every (sample, pixel of the padded plane,
    8 channels) of the output exactly once; replaying the stores with the
    plain version's integers (the halo's and the pad's as zeros) gives the
    plain version's packed tensor."""
    n, i, h, p, itemsize, address = case
    plan = k3.plan_quantize_activations(n, i, h, h, p, itemsize, address)
    assert plan.vec * itemsize in (16, 8, 4, 2, itemsize)
    assert (h * h) % plan.vec == 0 and address % (plan.vec * itemsize) == 0
    read = np.zeros(plan.count, np.int64)
    for t in range(plan.ta):
        e0, e1 = amax_tile_range(plan, t)
        read[e0:e1] += 1
    assert (read == 1).all()

    rng = np.random.RandomState(i + h + p)
    xq = rng.randint(-127, 128, size=(n, i, h * h)).astype(np.int8)
    plane = (h + 2 * p) ** 2
    out = np.full((n, plane, plan.ip), 99, np.int8)     # 99: never written
    count = np.zeros((n, plane, plan.ip // 8), np.int64)
    xpad = np.zeros((plan.ip, h * h), np.int8)
    for tile in range(plan.tq):
        pix, chan, width, src = quantize_tile_writes(plan, tile)
        assert (chan % width == 0).all() and (chan + width <= plan.ip).all()
        for wd in (8, 16):
            sel = width == wd
            p8, c8, s8 = pix[sel], chan[sel], src[sel]
            for s in range(n):
                for u in range(wd // 8):
                    np.add.at(count[s], (p8, c8 // 8 + u), 1)
                xpad[:i] = xq[s]
                rows = c8[:, None] + np.arange(wd)
                vals = np.where(s8[:, None] >= 0, xpad[rows, np.maximum(s8, 0)[:, None]], 0)
                out[s, p8[:, None], rows] = vals
    assert (count == 1).all()
    want = k3.pack_activations(torch.from_numpy(xq.reshape(n, i, h, h)).float(), p)
    np.testing.assert_array_equal(out.reshape(want.shape), want.numpy())


@pytest.mark.parametrize("case", WEIGHT_CASES, ids=_case_id)
def test_weight_stores_write_every_run_once(case):
    """The weight kernel's CTAs (one an output channel of O') store every
    (output channel, 16 input channels, tap) run of the packed tensor once;
    replaying the stores with the plain version's integers (zeros past O and
    I) gives its packed tensor."""
    o, i, itemsize, address = case
    plan = k3.plan_quantize_weights(o, i, itemsize, address)
    assert plan.bulk == int((i * 9 * itemsize) % 16 == 0 and address % 16 == 0)
    rng = np.random.RandomState(o + i)
    wq = rng.randint(-127, 128, size=(o, i, 3, 3)).astype(np.int8)
    flat = np.full((9, plan.op, plan.ip), 99, np.int8)
    count = np.zeros((9, plan.op, plan.ip // 16), np.int64)
    wpad = np.zeros((plan.op, plan.ip, 9), np.int8)
    wpad[:o, :i] = wq.reshape(o, i, 9)
    for cta in range(plan.op):
        oc, i0, tap = weight_cta_writes(plan, cta)
        assert (oc == cta).all()
        np.add.at(count, (tap, oc, i0 // 16), 1)
        cols = i0[:, None] + np.arange(16)
        flat[tap[:, None], oc[:, None], cols] = wpad[oc[:, None], cols, tap[:, None]]
    assert (count == 1).all()
    want = k3.unpack_weights(k3.pack_weights(torch.from_numpy(wq).float()))
    np.testing.assert_array_equal(flat, want.numpy())


@pytest.mark.parametrize("case", ACTIVATION_CASES + WEIGHT_CASES, ids=_case_id)
def test_quantizer_plans_fit_shared_memory(case):
    """Both kernels' shared memory (static and dynamic) stays within a CTA's
    232,448 bytes, and the bulk copy's row lands 16-byte aligned."""
    if len(case) == 6:
        n, i, h, p, itemsize, address = case
        assert k3.plan_quantize_activations(n, i, h, h, p, itemsize, address).smem \
            <= k3.SMEM_LIMIT
        return
    o, i, itemsize, address = case
    plan = k3.plan_quantize_weights(o, i, itemsize, address)
    assert plan.smem <= k3.SMEM_LIMIT and k3._Q8_W_BAR % 16 == 0


def test_weight_plan_refuses_a_row_beyond_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        k3.plan_quantize_weights(64, 7000, 4)


def _near_ties(scale, rng, count):
    """float32 values whose quotient by ``scale`` lies within a few units in
    the last place of a half-integer k + 1/2 (|k + 1/2| < 127.5), on both
    sides, and at it where float32 can hold it."""
    k = rng.randint(-127, 127, size=count).astype(np.float64) + 0.5
    v = (k * np.float64(scale)).astype(np.float32)
    step = rng.randint(-6, 7, size=count).astype(np.int32)
    return (v.view(np.int32) + step).view(np.float32)


@pytest.mark.parametrize("seed", range(6))
def test_certified_division_rounds_as_the_ieee_quotient(seed):
    """The kernels' quantize<Finite> (csrc/quantize_int8.cu) emulated in
    float32 with numpy, whose operations round to nearest even as the _rn
    intrinsics do: q = v * RN(1 / scale), and where q lies within 2^-14 of
    a half-integer the IEEE quotient v / scale itself. Its integers equal
    clip(rint(v / scale), -127, 127) of the IEEE quotient for every value:
    uniform ones, near ties on both sides, exact ties, zeros, subnormals,
    scales at the floor and near float32's largest, and the quotient is
    divided for only a small share of uniform values."""
    rng = np.random.RandomState(seed)
    magic = np.float32(1.5 * 2 ** 23)
    amaxes = np.concatenate([np.float32([1e-9, 1e-8, 1.0, 127.0, 3e38, 1e37]),
                             (10.0 ** rng.uniform(-6, 30, size=24)).astype(np.float32)])
    slow_share = []
    for amax in amaxes:
        scale = np.float32(max(amax, np.float32(1e-8))) / np.float32(127)
        v = (rng.uniform(-1, 1, size=20000) * np.float64(amax)).astype(np.float32)
        v = np.concatenate([v, _near_ties(scale, rng, 20000),
                            np.float32([0.0, -0.0, 1e-45, -3e-42, amax, -amax])])
        v = v[np.abs(v) <= amax]                       # a sample's values lie within its amax
        with np.errstate(over="ignore", under="ignore"):
            inv = np.float32(1) / scale
            q = v * inv
            t = q + magic
            near = np.abs(q - (t - magic)) >= np.float32(0.5 - 2 ** -14)
            exact = v / scale
        got = np.where(near, np.rint(exact), t - magic)
        want = np.clip(np.rint(exact), -127, 127)
        np.testing.assert_array_equal(got, want)
        slow_share.append(near[:20000].mean())
    assert np.mean(slow_share) < 1e-3
