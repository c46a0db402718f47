"""The depthwise FIR weights of ``ops/upfirdn2d`` kept on the device, on the
CPU.

``depthwise_conv2d`` looks the weight of numpy taps up by content and makes
it only on a miss, with the calls it made on every call before: the cached
path is held bit for bit to that uncached path (``_uncached`` below), in
float32 and bfloat16, for 1-D and 2-D taps, flipped (negative-stride) taps
and 1, 3 and 512 channels. Taps that differ in value, or a filter at another
dtype or channel count, get their own entry. The blur's float sigma, now
filled in on the device, equals the tensor sigma it was copied into before.
After its first call, a CoModGAN G forward and a train step with R1 copy no
taps; an export of G reads and writes no entry, so the cache holds no traced
tensor, and an eager forward and a second export still work.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from afcm_tpu_torch.infer import export as ex  # noqa: E402
from afcm_tpu_torch.models import (GANConfig, GANModel, build_discriminator,  # noqa: E402
                                   build_eval_model, build_generator)
from afcm_tpu_torch.models.gan_model import eval_forward  # noqa: E402
from afcm_tpu_torch.ops import conv2d_gradfix  # noqa: E402
from afcm_tpu_torch.ops.filter_design import setup_filter  # noqa: E402

torch.set_num_threads(1)

# ``ops/__init__`` binds the name ``upfirdn2d`` to the function
fir = importlib.import_module("afcm_tpu_torch.ops.upfirdn2d")

TINY_G = dict(netG="comodgan", z_dim=64, c_dim=1, w_dim=64, img_resolution=64,
              img_channels_in=4, img_channels_out=1,
              synthesis_kwargs=dict(name="SynthesisNetwork", channel_base=4096,
                                    channel_max=128, skip_resolution=32, cond_mod=True,
                                    conv_clamp=None, channel_attention=False,
                                    dropout_rate=0.0),
              mapping_kwargs=dict(name="MappingNetwork", num_layers=2))
TINY_D = dict(netD="comodgan", c_dim=1, img_resolution=64, img_channels=5,
              channel_base=1024, channel_max=32, epilogue_kwargs=dict(mbstd_group_size=2))
SHAPE = (4, 64, 64)

_F1 = setup_filter([1, 3, 3, 1], separable=True)            # 1-D, 4 taps
_F2 = setup_filter([1, 3, 3, 1])                            # 2-D, 4 x 4
TAPS = {
    "row": _F1[None, :],
    "column": _F1[:, None],
    "2d": _F2 * np.arange(1, 17, dtype=np.float32).reshape(4, 4),  # not symmetric
    "row_flipped": (_F1 * [1, 2, 3, 4])[::-1][None, :],
    "2d_flipped": (_F2 * np.arange(1, 17, dtype=np.float32).reshape(4, 4))[::-1, ::-1],
}


def _uncached(x, taps, stride=(1, 1), padding=(0, 0)):
    """``depthwise_conv2d`` as it was before the cache: the taps copied to
    the device, cast, expanded and made contiguous on every call."""
    channels = x.shape[1]
    taps = taps.copy() if isinstance(taps, np.ndarray) else taps.detach()
    weight = torch.as_tensor(taps, dtype=x.dtype, device=x.device)
    weight = weight[None, None].expand(channels, 1, *taps.shape).contiguous()
    return conv2d_gradfix.conv2d(x, weight, stride=stride, padding=padding,
                                 groups=channels)


def _entry(taps, channels, x):
    key = (np.asarray(taps).tobytes(), taps.shape, taps.dtype.str, channels,
           x.dtype, x.device)
    return fir._WEIGHTS.get(key)


@pytest.mark.parametrize("channels", [1, 3, 512])
@pytest.mark.parametrize("taps", list(TAPS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cached_depthwise_conv_is_bit_equal_to_uncached(dtype, taps, channels):
    f = TAPS[taps]
    x = torch.randn((2, channels, 9, 11), generator=torch.Generator().manual_seed(channels),
                    dtype=torch.float32).to(dtype)
    want = _uncached(x, f, stride=(1, 2), padding=(2, 1))
    for _ in range(2):                                      # a miss or a hit, then a hit
        got = fir.depthwise_conv2d(x, f, stride=(1, 2), padding=(2, 1))
        assert got.dtype == dtype and torch.equal(got, want)
    weight = _entry(f, channels, x)
    assert weight is not None and weight.is_contiguous() and not weight.requires_grad
    assert torch.equal(weight, torch.as_tensor(f.copy(), dtype=dtype)[None, None]
                       .expand(channels, 1, *f.shape))


def test_second_call_hits_without_a_copy():
    f = np.array([[0.25, 0.5, 0.125]], np.float32)
    x = torch.randn(1, 2, 5, 5)
    fir.depthwise_conv2d(x, f)
    uploads, hits = fir.tap_uploads, fir.tap_hits
    first = _entry(f, 2, x)
    fir.depthwise_conv2d(x, f)
    assert (fir.tap_uploads, fir.tap_hits) == (uploads, hits + 1)
    assert _entry(f, 2, x) is first


@pytest.mark.parametrize("other", ["values", "dtype", "channels"])
def test_keys_tell_filters_dtypes_and_channel_counts_apart(other):
    f = np.array([[1.0, 2.0, 1.0]], np.float32) / 4
    x = torch.randn(1, 3, 6, 6)
    g, y = f, x
    if other == "values":
        g = np.array([[1.0, 6.0, 1.0]], np.float32) / 8         # same shape
    elif other == "dtype":
        y = x.to(torch.bfloat16)
    else:
        y = torch.randn(1, 5, 6, 6)
    fir.depthwise_conv2d(x, f)
    uploads = fir.tap_uploads
    fir.depthwise_conv2d(y, g)
    assert fir.tap_uploads == uploads + (0 if _entry(g, y.shape[1], y) is None else 1)
    a, b = _entry(f, 3, x), _entry(g, y.shape[1], y)
    assert a is not None and b is not None and a is not b
    assert not (a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b))
    assert torch.equal(fir.depthwise_conv2d(y, g), _uncached(y, g))


def test_tensor_taps_bypass_the_cache():
    x = torch.randn(1, 2, 6, 6)
    taps = torch.tensor([[0.25, 0.5, 0.25]])
    entries, uploads, hits = len(fir._WEIGHTS), fir.tap_uploads, fir.tap_hits
    assert torch.equal(fir.depthwise_conv2d(x, taps), _uncached(x, taps))
    assert (len(fir._WEIGHTS), fir.tap_uploads, fir.tap_hits) == (entries, uploads, hits)


@pytest.mark.parametrize("sigma", [0.0, 0.2, 1.5, 10.0])
def test_blur_float_sigma_equals_tensor_sigma(sigma):
    x = torch.randn((2, 3, 16, 16), generator=torch.Generator().manual_seed(1))
    want = fir.gaussian_blur2d(x, torch.as_tensor(sigma, dtype=torch.float32), max_radius=30)
    assert torch.equal(fir.gaussian_blur2d(x, sigma, max_radius=30), want)


def test_a_miss_under_a_profiler_is_an_upload_span():
    f = np.array([[0.5, 0.375, 0.125]], np.float32)
    x = torch.randn(1, 7, 5, 5)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fir.depthwise_conv2d(x, f)
        fir.depthwise_conv2d(x, f)
    names = [e.name for e in prof.events()]
    assert names.count("afcm.fir.upload") == 1


def _tiny_gan():
    gen = torch.Generator().manual_seed(0)
    net_g = build_generator(dict(TINY_G), generator=gen)
    net_d = build_discriminator(dict(TINY_D), generator=gen)
    config = GANConfig(z_dim=64, c_dim=1, batch_size=2, blur_init_sigma=2.0,
                       blur_fade_kimg=1.0)
    return GANModel(config, build_generator(dict(TINY_G), generator=gen), net_g, net_d)


def _batch(n=2, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"A": torch.rand((n, *SHAPE), generator=gen) * 2 - 1,
            "B": torch.rand((n, 1, 64, 64), generator=gen) * 2 - 1,
            "slice_idx": torch.rand((n, 1), generator=gen)}


def test_comodgan_forward_and_r1_step_copy_no_taps_after_the_first():
    """A served forward (in inference mode) fills the cache first: the train
    step then saves those weights for R1's double backward, which an
    inference tensor would refuse."""
    model = _tiny_gan()
    batch = _batch()
    z = torch.randn((2, 64), generator=torch.Generator().manual_seed(2))
    for k in range(2):
        uploads, hits = fir.tap_uploads, fir.tap_hits
        with torch.inference_mode():
            eval_forward(model.generator_ema, 1, batch["A"], batch["slice_idx"], z)
        assert fir.tap_hits > hits
        assert k == 0 or fir.tap_uploads == uploads
    assert not any(w.is_inference() for w in fir._WEIGHTS.values())
    draws = torch.Generator().manual_seed(5)
    for k in range(2):
        uploads, hits = fir.tap_uploads, fir.tap_hits
        metrics = model.train_step(batch, cur_nimg=2.0 * (k + 1), z=z, generator=draws)
        assert float(metrics["D_r1"]) > 0
        assert fir.tap_hits > hits
        assert k == 0 or fir.tap_uploads == uploads


def test_export_reads_and_writes_no_entry_and_eager_runs_between():
    model = build_eval_model(dict(TINY_G), generator=torch.Generator().manual_seed(0))
    batch = _batch(seed=3)
    a, s = batch["A"], batch["slice_idx"]
    z = torch.randn((2, 64), generator=torch.Generator().manual_seed(4))
    entries = dict(fir._WEIGHTS)
    first = ex.export_eval(model, 2, SHAPE)
    assert fir._WEIGHTS == entries
    want = model.eval_step(a, s, z=z)
    entries = dict(fir._WEIGHTS)
    second = ex.export_eval(model, 2, SHAPE)
    assert fir._WEIGHTS == entries
    assert all(type(w) is torch.Tensor and not w.is_inference()
               for w in fir._WEIGHTS.values())
    for exported in (first, second):
        torch.testing.assert_close(exported.module()(a, s, z), want, rtol=0, atol=1e-6)
