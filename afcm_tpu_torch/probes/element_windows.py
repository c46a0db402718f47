"""Probe: overlapping input windows with unaligned offsets and implicit zero
fill, loaded straight from device memory.

The counterpart of ``scripts/probe_element_windows.py``: four cases on fp32
``[8, 64, 512]`` (windows of 128 along W at stride 64, at stride 48, with
offsets below 0 and past W, and with the channels zero-padded from 8 to 16),
each held bit for bit against the script's own numpy expression. That is
the halo load the fused ``filtered_lrelu`` kernel does per output tile, so
the same kernel is then timed at that kernel's own geometry, the square
input windows of its tiles at the generator's four filter variants, as GB/s
of window bytes read, beside the flat copy of the same input (the two
timed together in ``WINDOWS`` windows, taking turns: median, fastest and
slowest window).

    python -m afcm_tpu_torch.probes.element_windows [--device cpu] [--small]
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import CMSR_ADNI_G
from ..nn.stylegan3 import _design_layer_filters, compute_synthesis_layout
from ..ops.cuda import probe_stream as ps
from ..utils.profiling import time_windows
from . import banner, device_generator, probe_args

C, H, W, WIN = 8, 64, 512, 128
# (label, n windows, stride, low pad, channels out): probe_element_windows.py
# :39-50, :55-66, :71-87, :92-106
CASES = [("case 1 (overlap, stride 64)", 4, 64, 0, C),
         ("case 2 (overlap, stride 48)", 4, 48, 0, C),
         ("case 3 (implicit zero pad)", 5, 112, 16, C),
         ("case 4 (channel pad)", 2, WIN, 0, 16)]
# One full-size layer per filter variant of the shipped generator.
VARIANTS = {"A up2/down2 (L12_276_64)": ("decoder", 12),
            "B up2/down4 (encoder_4)": ("encoder", 4),
            "C up4/down2 (L10_276_128)": ("decoder", 10),
            "D crop (L13_256_64)": ("decoder", 13)}
_FUSED_SMEM = 48 * 1024 - 2 * 64 * 4     # csrc/filtered_lrelu.cu: launch()
WINDOWS = 5


def numpy_reference(xn, n_t, stride, lo, c_out):
    """The script's own expressions: pad with zeros, slice, stack, times 2."""
    hi = max(0, (n_t - 1) * stride - lo + WIN - xn.shape[2])
    xp = np.pad(xn, ((0, c_out - xn.shape[0]), (0, 0), (lo, hi)))
    return np.stack([xp[:, :, t * stride:t * stride + WIN] for t in range(n_t)]) * 2.0


def fused_tile_geometry(up, down, ntu, ntd, px0, out_size):
    """The output tile T the fused kernel picks for a layer and its input
    window (``csrc/filtered_lrelu.cu``: ``plan_tile``, ``launch``): returns
    (T, window edge L, window stride, low pad, tiles per axis)."""
    best = None
    for t in range(4, 65, 4):
        mid = (t - 1) * down + ntd
        win = (mid + ntu - 2 + up - 1) // up + 1
        smem = 4 * (max(win * win, mid * mid) + max(win * mid, t * mid))
        if smem > _FUSED_SMEM:
            continue
        taps_up = (ntu + up - 1) // up
        tiles = ((out_size + t - 1) // t) ** 2
        work = tiles * (win * mid * taps_up + mid * mid * taps_up + t * mid * ntd + t * t * ntd)
        if best is None or work < best[0]:
            best = (work, t, win)
    _, t, win = best
    return t, win, t * down // up, -((-px0) // up), (out_size + t - 1) // t


def variant_geometry(small: bool):
    kw = CMSR_ADNI_G["synthesis_kwargs"]
    layout = compute_synthesis_layout(
        CMSR_ADNI_G["img_resolution"], CMSR_ADNI_G["img_channels_in"],
        CMSR_ADNI_G["img_channels_out"], kw["channel_base"], kw["channel_max"],
        kw["num_layers"], kw["num_critical"], kw["first_cutoff"], kw["first_stopband"],
        kw["last_stopband_rel"], kw["margin_size"], kw["output_scale"],
        kw["skip_resolution"])
    for label, (side, idx) in VARIANTS.items():
        spec = (layout.decoder_specs if side == "decoder" else layout.encoder_specs)[idx]
        fu, fd, up, down, padding = _design_layer_filters(
            spec, False, kw["filter_size"], kw["lrelu_upsampling"], kw["use_radial_filters"])
        planes = 2 if small else 2 * spec.out_channels
        yield label, planes, spec.in_size + 2, spec.out_size, fused_tile_geometry(
            up, down, len(fu), len(fd), padding[0], spec.out_size)


def main(argv=None):
    args = probe_args(__doc__, argv)
    device = args.device
    banner(device)
    rows = []
    xn = np.random.RandomState(args.seed).randn(C, H, W).astype(np.float32)
    x = torch.from_numpy(xn).to(device)
    for label, n_t, stride, lo, c_out in CASES:
        out = ps.element_windows(x, WIN, n_t, stride, lo_w=lo, c_out=c_out)[0]
        ref = numpy_reference(xn, n_t, stride, lo, c_out)
        got = out.cpu().numpy()
        err = float(np.abs(got - ref).max()) if got.shape == ref.shape else float("inf")
        rows.append(dict(case=label, max_err=err, ok=err == 0))
        print(f"{label}: max err {err:.2e}", "OK" if err == 0 else "FAIL", flush=True)

    print("\nthe fused filtered_lrelu kernel's input windows (batch 2, fp32), loaded by "
          "the window kernel;\nGB/s of window bytes read | of the input once + the "
          "windows written; the flat copy of the input beside it", flush=True)
    gen = device_generator(device, args.seed)
    iters, windows = (2, 2) if args.small else (10, WINDOWS)
    for label, planes, in_size, out_size, (t, win, stride, lo, tiles) in \
            variant_geometry(args.small):
        xv = torch.randn((planes, in_size, in_size), generator=gen, device=device)
        call = dict(win_w=win, n_tw=tiles, stride_w=stride, lo_w=lo, win_h=win,
                    n_th=tiles, stride_h=stride, lo_h=lo)
        xb = xv.to(torch.bfloat16)
        timed = time_windows({"windows": lambda: ps.element_windows(xv, **call),
                              "copy": lambda: ps.stream_copy(xb)}, device, windows, iters)
        ms, copy_ms = timed["windows"]["ms"], timed["copy"]["ms"]
        window_bytes = tiles * tiles * planes * win * win * 4
        moved = xv.numel() * 4 + window_bytes
        rows.append(dict(variant=label, planes=planes, in_size=in_size, tile=t, window=win,
                         stride=stride, lo=lo, tiles=tiles * tiles, ms=ms,
                         window_bytes=window_bytes, moved_bytes=moved,
                         read_gbps=window_bytes / ms / 1e6, moved_gbps=moved / ms / 1e6,
                         ms_spread=[timed["windows"]["lo"], timed["windows"]["hi"]],
                         copy_ms=copy_ms, copy_gbps=2 * xb.numel() * 2 / copy_ms / 1e6))
        r = rows[-1]
        print(f"{label:26s} in {in_size:3d}^2 x{planes:4d}  tile {t:2d} window {win:3d}^2 "
              f"stride {stride:2d} lo {lo:3d} x{tiles * tiles:3d}: {ms:7.4f} ms "
              f"[{r['ms_spread'][0]:.4f}, {r['ms_spread'][1]:.4f}]  "
              f"{r['read_gbps']:6.0f} | {r['moved_gbps']:6.0f} GB/s; copy "
              f"{r['copy_gbps']:6.0f} GB/s", flush=True)
        del xv, xb
    return rows


if __name__ == "__main__":
    main()
