"""The yardstick's arithmetic: intervals, the trace reduction, FLOP counts,
rooflines and MFU."""

import math

import pytest
import torch

from portbench.harness import trace as tracing
from portbench.harness import yardstick as Y
from portbench.reference.gan import build_generator


def test_union_busy_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 9)]
    assert tracing.union(iv) == [(0, 3), (5, 6), (8, 9)]
    assert tracing.busy(iv) == 5
    assert tracing.gaps(iv, 1, 8.5) == [(3, 5), (6, 8)]
    assert tracing.clip(iv, 2.5, 5.6) == [(2.5, 3), (5, 5.6), (5.5, 5.6)]


def test_idle_time_is_split_by_the_spans_over_it():
    spans = [{"ts": 0, "dur": 4, "name": "portbench.load"},
             {"ts": 6, "dur": 2, "name": "portbench.fetch"}]
    assert tracing.idle_by_span((2, 10), spans) == {
        "portbench.load": 2, "portbench.fetch": 2, "other": 4}


def test_summarize_reads_busy_time_kernels_and_idle_gaps():
    events = [
        {"name": tracing.TAIL_SPAN, "cat": "user_annotation", "ts": 100, "dur": 100},
        {"name": "portbench.forward", "cat": "user_annotation", "ts": 100, "dur": 30},
        {"name": "k_a", "cat": "kernel", "ts": 90, "dur": 40},     # clipped to 100-130
        {"name": "k_b", "cat": "kernel", "ts": 120, "dur": 20},
        {"name": "copy", "cat": "gpu_memcpy", "ts": 170, "dur": 10},
        {"name": "k_c", "cat": "kernel", "ts": 250, "dur": 10},    # outside the tail
    ]
    s = tracing.summarize(events)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(50e-6)              # 100-140 and 170-180
    assert dict(s["device_ops"]) == pytest.approx({"k_a": 40e-6, "k_b": 20e-6, "copy": 10e-6})
    assert dict(s["idle_gaps"]) == pytest.approx({"other": 50e-6})
    assert tracing.kernel_seconds(s, "k_") == (pytest.approx(60e-6), 2)


def shipped_cfg(path):
    from afcm_tpu_torch.config import default_argument_parser
    return default_argument_parser(["--config-file", path, "tpu.compute_dtype",
                                    "bfloat16"]).to_dict()


def test_cmsr_slice_does_514_9_gflop_of_layer_3x3_convs():
    """The 3x3 convs of the 14 encoder and 15 decoder layers: the counted
    total less the bottleneck's e_16x16 conv (512 -> 512 at 36^2)."""
    cfg = shipped_cfg("configs/adni/stylegan3/cmsr.yml")
    work = Y.serve_work(cfg)
    with torch.device("meta"):
        g = build_generator(cfg["model"]["G"], compute_dtype="bfloat16")
    c = g.synthesis.layout.bottleneck_channels
    size = g.synthesis.layout.encoder_specs[-1].out_size
    e16 = 2.0 * c * c * 9 * size * size
    assert (work["conv3x3"] - e16) / 1e9 == pytest.approx(514.9, abs=0.05)
    assert work["bf16"] / 1e9 == pytest.approx(521.05, abs=0.05)
    assert work["fp32"] == pytest.approx(Y.fir_flops_fp32(g.synthesis, 1))


def test_fir_fmas_by_hand():
    # 1 plane, 10 -> 4, up 2, down 2, 12 taps up, 6 down
    mid = (4 - 1) * 2 + 6
    up = (10 * mid + mid * mid) * 6
    down = (4 * mid + 4 * 4) * 6
    assert Y.fir_fmas(1, 1, 10, 4, 2, 2, 12, 6) == up + down
    assert Y.fir_fmas(1, 1, 10, 4, 2, 2, 12, 6, backward=True) == 2 * up + down


def test_filtered_lrelu_bound_takes_the_larger_of_bytes_and_flops():
    layer = (148, 148, 362, 2, 2, 12, 12)
    n, el = 16, 2
    b = Y.filtered_lrelu_bound_s(n, layer, el)
    by_bytes = (n * 362 * 148 * 148 * el * 2 + 362 * el) / Y.HBM_BYTES_PER_S
    by_ops = 2 * Y.fir_fmas(n, 362, 148, 148, 2, 2, 12, 12) / Y.PEAK_FLOPS["fp32"]
    assert b == pytest.approx(max(by_bytes, by_ops))


def test_mfu_is_a_share_of_the_least_time_and_silent_without_a_rate():
    flops = {"bf16": 989e12, "fp32": 67e12}          # 2 s at the peaks
    assert Y.mfu(flops, 0.5) == pytest.approx(100.0)
    assert Y.mfu(flops, 0.25) == pytest.approx(50.0)
    assert Y.mfu(flops, 4.0, items=16) == pytest.approx(50.0)
    assert Y.mfu(flops, 0) is None and Y.mfu(flops, float("nan")) is None


def test_roofline_counts_whole_passes_and_is_silent_without_k1():
    from portbench.harness.rooflines import roofline
    cfg = shipped_cfg("configs/adni/stylegan3/cmsr.yml")
    with torch.device("meta"):
        g = build_generator(cfg["model"]["G"], compute_dtype="bfloat16")
    layers = Y.k1_layers(g.synthesis)
    assert len(layers) == 28
    bound = Y.forward_k1_bound_s(g.synthesis, 16, 2)
    trace = {"kernels": {"filtered_lrelu_fwd_spec_kernel<a>": {"s": 2 * bound * 2, "calls": 56}}}
    assert roofline({"trace": trace, "config": cfg}, "filtered_lrelu_fwd_", False) \
        == pytest.approx(50.0)
    trace["kernels"]["filtered_lrelu_fwd_spec_kernel<a>"]["calls"] = 55
    with pytest.raises(AssertionError):
        roofline({"trace": trace, "config": cfg}, "filtered_lrelu_fwd_", False)
    assert roofline({"trace": {"kernels": {}}, "config": cfg}, "filtered_lrelu_fwd_", False) is None
    ccsr = shipped_cfg("configs/adni/comodgan/ccsr.yml")
    assert roofline({"trace": trace, "config": ccsr}, "filtered_lrelu_fwd_", False) is None


def test_train_work_counts_both_phases():
    cfg = shipped_cfg("configs/adni/stylegan3/cmsr.yml")
    serve = Y.serve_work(cfg)
    train = Y.train_work(cfg)
    n = cfg["loaders"]["batch_size"]
    # the G forward and its two backward terms, and D's passes besides
    assert train["bf16"] / n > 3 * serve["bf16"]
    assert math.isfinite(Y.least_seconds({k: v for k, v in train.items()
                                          if k in Y.PEAK_FLOPS}))
