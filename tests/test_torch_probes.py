"""The port's probe kernels (K5-K9) on the CPU, against the JAX package's.

Each plain PyTorch version (what a CPU tensor takes, and what the card's
checks hold the CUDA kernel to) runs on inputs made from a seed with numpy,
beside the TPU probe script's own Pallas kernel in interpret mode. The
scripts pass no ``interpret`` flag, so a fixture wraps
``jax.experimental.pallas.pallas_call`` to force it and loads each script
from its file; nothing under ``scripts/`` changes. Every comparison is
exact (``assert_array_equal``): copies, powers of two, bf16 sums in a fixed
order and integer products have no tolerance to state.

The window probe (K7) is the exception: in interpret mode the out-of-bounds
fill of ``pl.Element`` blocks is not zero (cases 3 and 4 of the script give
NaN there), so all four cases are held against the script's own numpy
expressions, and the script's kernel is held to them where interpret mode
can run it (cases 1 and 2).
"""

import importlib.util
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from afcm_tpu_torch.ops.cuda import probe_int8 as p8  # noqa: E402
from afcm_tpu_torch.ops.cuda import probe_stream as ps  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBES = ("fir_roofline", "stream_diag", "element_windows", "int8_matmul",
          "int8_kernel")


@pytest.fixture(scope="module")
def scripts():
    """The five probe scripts as modules, their pallas_call in interpret mode."""
    original = pl.pallas_call

    def interpreted(*args, **kwargs):
        kwargs["interpret"] = True
        return original(*args, **kwargs)

    patch = pytest.MonkeyPatch()
    patch.setattr(pl, "pallas_call", interpreted)
    loaded = {}
    for name in ("probe_fir_roofline", "probe_stream_diag", "probe_element_windows",
                 "bench_int8_matmul", "diag_int8_kernel"):
        spec = importlib.util.spec_from_file_location(
            f"_probe_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
        loaded[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(loaded[name])
    yield loaded
    patch.undo()


def bf16_pair(rng, shape):
    """The same bf16 values as a jax array and a torch tensor."""
    x32 = rng.randn(*shape).astype(np.float32)
    return jnp.asarray(x32, jnp.bfloat16), torch.from_numpy(x32).to(torch.bfloat16)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# K5: C = 64 gives two channel blocks of 32 in the script's blocking.
C, H, W = 64, 16, 20


def blocked(x, cb):
    """[C, 4, H, W] -> the script's block-interleaved [4C, H, W]."""
    c, _, h, w = x.shape
    return x.reshape(c // cb, cb, 4, h, w).transpose(0, 2, 1, 3, 4).reshape(4 * c, h, w)


def unblocked(y, cb):
    """The script's block-interleaved [4C, H, W] -> [C, 4, H, W]."""
    c4, h, w = y.shape
    return y.reshape(c4 // (4 * cb), 4, cb, h, w).transpose(0, 2, 1, 3, 4).reshape(
        c4 // 4, 4, h, w)


@pytest.mark.parametrize("kernel", ["copy", "wr4x", "rd4x", "chain"])
def test_stream_kernels_match_jax(scripts, rng, kernel):
    script = scripts["probe_fir_roofline"]
    cb, _ = script._blocks(C, H, W)
    assert C // cb == 2
    if kernel == "rd4x":
        x4 = rng.randn(C, 4, H, W).astype(np.float32)
        call = script.build_rd4x(C, H, W)[0]
        want = f32(call(jnp.asarray(blocked(x4, cb), jnp.bfloat16)))
        got = f32(ps.stream_rd4x(torch.from_numpy(x4).to(torch.bfloat16)))
    else:
        xj, xt = bf16_pair(rng, (C, H, W))
        build = getattr(script, f"build_{kernel}")
        want = f32(build(C, H, W)[0](xj))
        got = f32({"copy": ps.stream_copy, "wr4x": ps.stream_wr4x,
                   "chain": ps.stream_chain}[kernel](xt))
        if kernel == "wr4x":
            want = unblocked(want, cb)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_chain_rounds_every_step_to_bf16(rng):
    """The plain chain differs from the same chain in float32: the test
    above would not notice a version that rounds only at the end."""
    _, xt = bf16_pair(rng, (8, 16, 20))
    t = torch.stack([xt.float() * s for s in (1, 0.5, 0.25, 0.125)], 1)
    t = torch.where(t > 0, t, 0.2 * t)
    late = ((t[:, 0] + t[:, 1]) + (t[:, 2] + t[:, 3])).to(torch.bfloat16)
    assert not torch.equal(late, ps.stream_chain(xt))


@pytest.mark.parametrize("cb", [4, 8, 16])
def test_copy3d_matches_jax(scripts, rng, cb):
    xj, xt = bf16_pair(rng, (16, 12, 20))
    want = f32(scripts["probe_stream_diag"].copy3d(16, 12, 20, cb)(xj))
    np.testing.assert_array_equal(f32(ps.copy3d(xt, cb)), want)


@pytest.mark.parametrize("br", [8, 16])
def test_copy2d_matches_jax(scripts, rng, br):
    xj, xt = bf16_pair(rng, (32, 128))
    want = f32(scripts["probe_stream_diag"].copy2d(32, 128, br)(xj))
    np.testing.assert_array_equal(f32(ps.copy2d(xt, br)), want)


# K7: (windows, stride, low pad, channels out) of the script's four cases
WINDOW_CASES = {"overlap_stride_64": (4, 64, 0, 8), "overlap_stride_48": (4, 48, 0, 8),
                "implicit_zero_pad": (5, 112, 16, 8), "channel_pad": (2, 128, 0, 16)}


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_element_windows_match_the_scripts_numpy_reference(case):
    n_t, sw, lo, c_pad = WINDOW_CASES[case]
    xn = np.random.RandomState(0).randn(8, 64, 512).astype(np.float32)
    # probe_element_windows.py :50, :66, :85-87, :105-106
    xp = np.pad(xn, ((0, c_pad - 8), (0, 0), (lo, 80 if lo else 0)))
    ref = np.stack([xp[:, :, t * sw:t * sw + 128] for t in range(n_t)]) * 2.0
    got = ps.element_windows(torch.from_numpy(xn), 128, n_t, sw, lo_w=lo, c_out=c_pad)
    assert tuple(got.shape) == (1,) + ref.shape
    np.testing.assert_array_equal(got[0].numpy(), ref)


def test_element_windows_script_kernel_where_interpret_mode_runs_it(scripts, capsys):
    """The script's own check of its Pallas kernel against those numpy
    expressions passes in interpret mode for the in-bounds cases; the
    zero-filled cases need the chip."""
    scripts["probe_element_windows"].main()
    out = capsys.readouterr().out
    assert "case 1 (overlap, stride 64): max err 0.00e+00 OK" in out
    assert "case 2 (overlap, stride 48): max err 0.00e+00 OK" in out


def test_element_windows_in_two_dimensions(rng):
    """Windows along H too (the fused kernel's tile geometry), against
    explicit indexing with zero fill, offsets below 0 and past the edge."""
    x = torch.from_numpy(rng.randn(3, 10, 13).astype(np.float32))
    got = ps.element_windows(x, 6, 3, 5, lo_w=2, win_h=7, n_th=2, stride_h=6, lo_h=3,
                             scale=1.0)
    assert tuple(got.shape) == (2, 3, 3, 7, 6)
    for ty in range(2):
        for tx in range(3):
            for r in range(7):
                for q in range(6):
                    gy, gx = ty * 6 - 3 + r, tx * 5 - 2 + q
                    want = x[:, gy, gx] if 0 <= gy < 10 and 0 <= gx < 13 else torch.zeros(3)
                    assert torch.equal(got[ty, tx, :, r, q], want)


@pytest.mark.parametrize("b_layout", ["kil", "kli"])
def test_stacked_matmul_matches_jax(scripts, rng, b_layout):
    a = rng.randint(-127, 127, (16, 32)).astype(np.int8)
    b = rng.randint(-127, 127, (3, 32, 256)).astype(np.int8)
    want = np.asarray(scripts["bench_int8_matmul"].pallas_stacked(
        jnp.asarray(a), jnp.asarray(b), 128))
    bt = torch.from_numpy(b)
    if b_layout == "kli":
        bt = bt.transpose(1, 2).contiguous()
    got = p8.stacked_matmul_int8(torch.from_numpy(a), bt, b_layout)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode,o,i", [("dot1", 32, 16), ("aligned", 32, 16),
                                      ("slices", 32, 16), ("sliceonly", 32, 16),
                                      ("sliceonly", 16, 32)])
def test_nine_tap_matches_jax(scripts, rng, monkeypatch, mode, o, i):
    script = scripts["diag_int8_kernel"]
    cols, wp, steps = 128, 8, 2
    win = cols + 2 * wp + 2
    for name, value in dict(O=o, I=i, COLS=cols, WP=wp, STEPS=steps, WIN=win,
                            WINP=256).items():
        monkeypatch.setattr(script, name, value)
    w9 = rng.randint(-127, 127, (9, o, i)).astype(np.int8)
    x = rng.randint(-127, 127, (steps, i, 256)).astype(np.int8)
    want = script.make(mode)(jnp.asarray(w9), jnp.asarray(x))
    got = p8.nine_tap_int8(torch.from_numpy(w9), torch.from_numpy(x), mode, cols, wp)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (steps, o, cols)
    np.testing.assert_array_equal(f32(got), f32(want))


# (offsets, O, I): unsorted, far apart, one tap and nine, I above and
# below O
SLICE_SUMS = {"unsorted_nine": ([44, 0, 23, 1, 42, 2, 21, 22, 43], 24, 16),
              "far_apart": ([0, 1, 150, 299, 301, 17, 400, 407, 2], 8, 12),
              "one_tap": ([5], 6, 6), "i_greater_than_o": ([3, 1, 2], 5, 9),
              "repeated_offset": ([7, 7, 0], 10, 4)}


@pytest.mark.parametrize("case", list(SLICE_SUMS))
def test_slice_sum_plain_matches_a_numpy_loop(rng, case):
    """slice_sum_int8 (K9 sliceonly at any offsets) on the CPU against the
    sum written out element by element and rounded once to bf16, exactly."""
    offsets, o, i = SLICE_SUMS[case]
    cols, steps = 16, 2
    x = rng.randint(-128, 128, (steps, i, max(offsets) + cols + 3)).astype(np.int8)
    want = np.zeros((steps, o, cols), dtype=np.int64)
    for s in range(steps):
        for r in range(min(o, i)):
            for n in range(cols):
                want[s, r, n] = sum(int(x[s, r, off + n]) for off in offsets)
    before = dict(p8.launches)
    got = p8.slice_sum_int8(torch.from_numpy(x), offsets, o, cols)
    assert p8.launches == before
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (steps, o, cols)
    rounded = torch.from_numpy(want.astype(np.float32)).to(torch.bfloat16)
    np.testing.assert_array_equal(f32(got), f32(rounded))


def test_int_to_bf16_rounds_through_float32():
    """The cast the kernels and their plain versions share, at sums beyond
    2^24 where the order of the two roundings shows."""
    acc = torch.tensor([2 ** 24 + 1, 50_462_977, -50_462_977, 3], dtype=torch.int32)
    assert torch.equal(p8.to_bf16(acc), acc.to(torch.bfloat16))


def _stream(**kw):
    return torch.zeros(kw.pop("shape", (4, 4, 8)), dtype=kw.pop("dtype", torch.bfloat16))


BAD_CALLS = {
    "copy_float32": lambda: ps.stream_copy(_stream(dtype=torch.float32)),
    "copy_strided": lambda: ps.stream_copy(_stream()[:, :, ::2]),
    "wr4x_rank": lambda: ps.stream_wr4x(_stream(shape=(4, 8))),
    "rd4x_without_four": lambda: ps.stream_rd4x(_stream(shape=(4, 3, 4, 8))),
    "chain_tile": lambda: ps.stream_chain(_stream(), tile=300),
    "chain_tile_beyond_shared_memory": lambda: ps.stream_chain(_stream(), tile=4096),
    "copy3d_blocks": lambda: ps.copy3d(_stream(), 3),
    "copy2d_rank": lambda: ps.copy2d(_stream(), 2),
    "windows_bf16": lambda: ps.element_windows(_stream(), 4, 2, 2),
    "windows_fewer_channels": lambda: ps.element_windows(
        _stream(dtype=torch.float32), 4, 2, 2, c_out=2),
    "matmul_layout": lambda: p8.stacked_matmul_int8(
        torch.zeros((16, 32), dtype=torch.int8), torch.zeros((2, 32, 8), dtype=torch.int8), "lik"),
    "matmul_inner": lambda: p8.stacked_matmul_int8(
        torch.zeros((16, 32), dtype=torch.int8), torch.zeros((2, 16, 8), dtype=torch.int8)),
    "matmul_float": lambda: p8.stacked_matmul_int8(
        torch.zeros((16, 32)), torch.zeros((2, 32, 8), dtype=torch.int8)),
    "nine_tap_mode": lambda: p8.nine_tap_int8(
        torch.zeros((9, 16, 8), dtype=torch.int8), torch.zeros((1, 8, 64), dtype=torch.int8),
        "im2col", 16, 4),
    "nine_tap_window": lambda: p8.nine_tap_int8(
        torch.zeros((9, 16, 8), dtype=torch.int8), torch.zeros((1, 8, 24), dtype=torch.int8),
        "slices", 16, 4),
    # Not on the CPU: these reach the card's branch, whose shape gates raise
    # before anything is built or launched.
    "matmul_ragged_on_device": lambda: p8.stacked_matmul_int8(
        torch.zeros((16, 64), dtype=torch.int8, device="meta"),
        torch.zeros((2, 64, 128), dtype=torch.int8, device="meta")),
    "slice_sum_offsets": lambda: p8.slice_sum_int8(
        torch.zeros((1, 8, 24), dtype=torch.int8), [0, 9], 8, 16),
    "slice_sum_ten_taps": lambda: p8.slice_sum_int8(
        torch.zeros((1, 8, 24), dtype=torch.int8), [0] * 10, 8, 16),
    "slice_sum_ragged_on_device": lambda: p8.slice_sum_int8(
        torch.zeros((1, 8, 36), dtype=torch.int8, device="meta"), [0, 1], 8, 12),
    "nine_tap_ragged_on_device": lambda: p8.nine_tap_int8(
        torch.zeros((9, 128, 32), dtype=torch.int8, device="meta"),
        torch.zeros((1, 32, 256), dtype=torch.int8, device="meta"), "aligned", 128, 8),
}


@pytest.mark.parametrize("call", list(BAD_CALLS))
def test_wrappers_raise_on_what_the_kernels_do_not_take(call):
    before = dict(ps.launches), dict(p8.launches)
    with pytest.raises(ValueError):
        BAD_CALLS[call]()
    assert (dict(ps.launches), dict(p8.launches)) == before


def test_cpu_tensors_launch_no_kernel(rng):
    ps.reset_launches()
    p8.reset_launches()
    _, xt = bf16_pair(rng, (4, 4, 8))
    ps.stream_chain(xt)
    ps.copy3d(xt, 2)
    p8.stacked_matmul_int8(torch.zeros((4, 8), dtype=torch.int8),
                           torch.zeros((1, 8, 4), dtype=torch.int8))
    assert not any(ps.launches.values()) and not any(p8.launches.values())


@pytest.mark.parametrize("name", PROBES)
def test_probe_entry_point_prints_its_table(name, capsys):
    module = importlib.import_module(f"afcm_tpu_torch.probes.{name}")
    rows = module.main(["--device", "cpu", "--small"])
    out = capsys.readouterr().out
    assert out.startswith("device: cpu")
    assert rows and all(isinstance(row, dict) for row in rows)
    marker = {"fir_roofline": "chain", "stream_diag": "copy2d", "element_windows":
              "case 4 (channel pad): max err 0.00e+00 OK", "int8_matmul": "TOP/s",
              "int8_kernel": "sliceonly"}[name]
    assert marker in out


@pytest.mark.parametrize("name", PROBES)
def test_probe_entry_point_needs_a_card_by_default(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    module = importlib.import_module(f"afcm_tpu_torch.probes.{name}")
    with pytest.raises(RuntimeError, match="--device cpu"):
        module.main(["--small"])


def test_fused_tile_geometry_of_the_window_probe():
    """The window probe's copy of the fused kernel's tile plan: windows
    cover the input the tiles need, strides are whole."""
    from afcm_tpu_torch.probes.element_windows import variant_geometry
    rows = list(variant_geometry(small=False))
    assert [r[1] for r in rows] == [128, 362, 256, 128]          # planes at batch 2
    for _, _, in_size, out_size, (t, win, stride, lo, tiles) in rows:
        assert tiles * t >= out_size > (tiles - 1) * t
        assert 0 < stride < win <= in_size
        assert (tiles - 1) * stride - lo < in_size
