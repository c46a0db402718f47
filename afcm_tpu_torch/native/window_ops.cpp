// Native host-side hot loops for the data pipeline.
//
// The reference delegates its host-side work to torch DataLoader worker
// processes (reference: data/__init__.py:61-92); this box has one CPU core,
// so the per-batch work must be tight single-thread code instead:
//  * assemble_windows: gather 4-slice thick windows from a uint8 volume and
//    normalize to [-1, 1] float32 in one pass (fuses the Normalize transform)
//  * accumulate_patches: overlap-add halo-cropped prediction patches into the
//    output volume accumulator.
//
// Built with `g++ -O3 -shared -fPIC` by afcm_tpu_torch/native/build.py and loaded
// via ctypes; a numpy fallback covers toolchain-less environments.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <cmath>
#include <vector>

extern "C" {

// volume: [depth, height, width] uint8
// window_indices: [batch * slices_per_window] int32 slice indices; -1 = zero pad
// out: [batch, slices_per_window, height, width] float32 in [-1, 1]
void assemble_windows(const uint8_t* volume, int depth, int height, int width,
                      const int32_t* window_indices, int batch,
                      int slices_per_window, float lo, float inv_range,
                      float* out) {
    const long plane = static_cast<long>(height) * width;
    const float pad_value = std::max(-1.0f, std::min(1.0f, 2.0f * (0.0f - lo) * inv_range - 1.0f));
    for (int b = 0; b < batch; ++b) {
        for (int s = 0; s < slices_per_window; ++s) {
            const int32_t z = window_indices[b * slices_per_window + s];
            float* dst = out + (static_cast<long>(b) * slices_per_window + s) * plane;
            if (z < 0 || z >= depth) {
                for (long i = 0; i < plane; ++i) dst[i] = pad_value;
                continue;
            }
            const uint8_t* src = volume + static_cast<long>(z) * plane;
            for (long i = 0; i < plane; ++i) {
                float v = 2.0f * (static_cast<float>(src[i]) - lo) * inv_range - 1.0f;
                dst[i] = std::max(-1.0f, std::min(1.0f, v));
            }
        }
    }
}

// pmap / nmask: [depth, height, width]; patches: [batch, ph, pw] float32
// coords: [batch * 3] (z, y0, x0) destination origins after halo crop
// sizes:  [batch * 2] (crop_h, crop_w); offsets: [batch * 2] in-patch offsets
void accumulate_patches(float* pmap, uint16_t* nmask, int depth, int height,
                        int width, const float* patches, int batch, int ph,
                        int pw, const int32_t* coords, const int32_t* offsets,
                        const int32_t* sizes) {
    (void)depth;
    const long plane = static_cast<long>(height) * width;
    for (int b = 0; b < batch; ++b) {
        const int z = coords[b * 3 + 0];
        const int y0 = coords[b * 3 + 1];
        const int x0 = coords[b * 3 + 2];
        const int oy = offsets[b * 2 + 0];
        const int ox = offsets[b * 2 + 1];
        const int ch = sizes[b * 2 + 0];
        const int cw = sizes[b * 2 + 1];
        const float* patch = patches + static_cast<long>(b) * ph * pw;
        float* pz = pmap + static_cast<long>(z) * plane;
        uint16_t* nz = nmask + static_cast<long>(z) * plane;
        for (int y = 0; y < ch; ++y) {
            const float* src = patch + static_cast<long>(oy + y) * pw + ox;
            float* dstp = pz + static_cast<long>(y0 + y) * width + x0;
            uint16_t* dstn = nz + static_cast<long>(y0 + y) * width + x0;
            for (int x = 0; x < cw; ++x) {
                dstp[x] += src[x];
                dstn[x] += 1;
            }
        }
    }
}

// ---- fused SSIM (skimage structural_similarity semantics) ------------------
//
// Box-filters the five moment fields (x, y, x*x, y*y, x*y) with a uniform
// window (scipy.ndimage.uniform_filter, mode='reflect') along every axis,
// then reduces the SSIM map over the win//2-cropped interior. float64
// throughout — numerically matches afcm_tpu_torch/utils/metrics.py ssim()
// (reference: util/evaluation.py via skimage) to ~1e-12; the win is doing
// it in 16 fused streaming passes instead of ~30 temporary-allocating numpy
// ops on this 1-core host (measured 7.9 s -> <1 s on a 64x256x256 volume).

namespace {

// scipy mode='reflect': (d c b a | a b c d | d c b a) — edge duplicated.
inline long reflect_index(long j, long n) {
    if (n == 1) return 0;
    const long period = 2 * n;
    j %= period;
    if (j < 0) j += period;
    return j < n ? j : period - 1 - j;
}

// Uniform filter along `axis` of a C-contiguous [dims[0], ..] array,
// src -> dst (distinct buffers). Odd `win` (centered window), reflect pad.
void box_filter_axis(const double* src, double* dst, const long* dims,
                     int nd, int axis, int win) {
    long n = dims[axis];
    long inner = 1;
    for (int a = axis + 1; a < nd; ++a) inner *= dims[a];
    long outer = 1;
    for (int a = 0; a < axis; ++a) outer *= dims[a];
    const int pad = win / 2;
    const double inv = 1.0 / win;

    if (inner == 1) {
        // contiguous (last) axis: per-line reflect-padded temp + moving sum
        std::vector<double> tmp(n + 2 * pad);
        for (long o = 0; o < outer; ++o) {
            const double* line = src + o * n;
            double* out = dst + o * n;
            for (long i = -pad; i < n + pad; ++i)
                tmp[i + pad] = line[reflect_index(i, n)];
            double s = 0.0;
            for (int k = 0; k < win; ++k) s += tmp[k];
            out[0] = s * inv;
            for (long i = 1; i < n; ++i) {
                s += tmp[i + win - 1] - tmp[i - 1];
                out[i] = s * inv;
            }
        }
        return;
    }

    // non-last axis: vectorize the moving sum across the `inner` columns
    std::vector<double> sums(inner);
    for (long o = 0; o < outer; ++o) {
        const double* base = src + o * n * inner;
        double* out = dst + o * n * inner;
        std::fill(sums.begin(), sums.end(), 0.0);
        for (long j = -pad; j <= pad; ++j) {
            const double* row = base + reflect_index(j, n) * inner;
            for (long c = 0; c < inner; ++c) sums[c] += row[c];
        }
        for (long c = 0; c < inner; ++c) out[c] = sums[c] * inv;
        for (long i = 1; i < n; ++i) {
            const double* add = base + reflect_index(i + pad, n) * inner;
            const double* sub = base + reflect_index(i - 1 - pad, n) * inner;
            double* orow = out + i * inner;
            for (long c = 0; c < inner; ++c) {
                sums[c] += add[c] - sub[c];
                orow[c] = sums[c] * inv;
            }
        }
    }
}

}  // namespace

// x / y: C-contiguous float64 arrays of shape dims[0..nd-1] (nd <= 4).
// Writes mean(SSIM map over the pad-cropped interior) to *out_mean.
void ssim_mean(const double* x, const double* y, const long* dims, int nd,
               int win, double c1, double c2, double cov_norm,
               double* out_mean) {
    long total = 1;
    for (int a = 0; a < nd; ++a) total *= dims[a];

    // five moment fields + one scratch for the out-of-place axis passes
    std::vector<double> ux(x, x + total), uy(y, y + total);
    std::vector<double> uxx(total), uyy(total), uxy(total), scratch(total);
    for (long i = 0; i < total; ++i) {
        uxx[i] = x[i] * x[i];
        uyy[i] = y[i] * y[i];
        uxy[i] = x[i] * y[i];
    }
    double* fields[5] = {ux.data(), uy.data(), uxx.data(), uyy.data(),
                         uxy.data()};
    double* spare = scratch.data();
    for (int axis = 0; axis < nd; ++axis) {
        for (double*& f : fields) {
            box_filter_axis(f, spare, dims, nd, axis, win);
            std::swap(f, spare);  // rotate buffers instead of copying back
        }
    }

    // mean of the SSIM map over the interior [pad, dim-pad) box
    const int pad = (win - 1) / 2;
    long lo[4] = {0, 0, 0, 0}, hi[4] = {1, 1, 1, 1};
    for (int a = 0; a < nd; ++a) { lo[a] = pad; hi[a] = dims[a] - pad; }
    long strides[4] = {0, 0, 0, 0};
    strides[nd - 1] = 1;
    for (int a = nd - 2; a >= 0; --a) strides[a] = strides[a + 1] * dims[a + 1];

    long double acc = 0.0L;
    long count = 0;
    for (long i0 = lo[0]; i0 < hi[0]; ++i0)
        for (long i1 = (nd > 1 ? lo[1] : 0); i1 < (nd > 1 ? hi[1] : 1); ++i1)
            for (long i2 = (nd > 2 ? lo[2] : 0); i2 < (nd > 2 ? hi[2] : 1); ++i2)
                for (long i3 = (nd > 3 ? lo[3] : 0); i3 < (nd > 3 ? hi[3] : 1);
                     ++i3) {
                    const long idx = i0 * strides[0] +
                                     (nd > 1 ? i1 * strides[1] : 0) +
                                     (nd > 2 ? i2 * strides[2] : 0) +
                                     (nd > 3 ? i3 * strides[3] : 0);
                    const double mx = fields[0][idx], my = fields[1][idx];
                    const double vx = cov_norm * (fields[2][idx] - mx * mx);
                    const double vy = cov_norm * (fields[3][idx] - my * my);
                    const double vxy = cov_norm * (fields[4][idx] - mx * my);
                    const double a1 = 2.0 * mx * my + c1;
                    const double a2 = 2.0 * vxy + c2;
                    const double b1 = mx * mx + my * my + c1;
                    const double b2 = vx + vy + c2;
                    acc += (a1 * a2) / (b1 * b2);
                    ++count;
                }
    *out_mean = static_cast<double>(acc / count);
}

// Fused per-slice PSNR/SSIM means over axis 0 of two [D, H, W] float64
// volumes (utils/metrics.py threed_slice_psnr/threed_slice_ssim — the
// reference's evaluation.py:116-121 protocol), one call instead of a
// 2*D-iteration Python loop:
//   - slices whose TARGET (`l`) max is <= 0 are skipped (both metrics);
//   - PSNR normalizes each slice by its OWN max (t/t.max()) and uses the
//     float data-range-2 convention => 10*log10(4 / mse) — quirks
//     preserved from the reference/skimage semantics;
//   - SSIM runs on the raw slices via the ssim_mean machinery above
//     (uniform window, reflect boundary, data-range-2 constants fed by
//     the caller as c1/c2/cov_norm).
// Writes {psnr_mean, ssim_mean, kept_slice_count} to out3.
void slice_metrics(const double* g, const double* l, long d, long h, long w,
                   int win, double c1, double c2, double cov_norm,
                   double* out3) {
    const long n = h * w;
    const long dims[2] = {h, w};
    // Slice-sized moment buffers allocated ONCE and reused across slices:
    // cache-resident (6 x ~0.5 MB at 256^2) — a whole-volume batched
    // variant measured 1.6x SLOWER (200 MB of fields falls out of cache),
    // and per-slice ssim_mean() calls pay 6 allocations per slice.
    std::vector<double> ux(n), uy(n), uxx(n), uyy(n), uxy(n), scratch(n);
    const int pad = (win - 1) / 2;
    long double psnr_acc = 0.0L, ssim_acc = 0.0L;
    long count = 0;
    for (long i = 0; i < d; ++i) {
        const double* li = l + i * n;
        const double* gi = g + i * n;
        double lmax = li[0], gmax = gi[0];
        for (long j = 1; j < n; ++j) {
            if (li[j] > lmax) lmax = li[j];
            if (gi[j] > gmax) gmax = gi[j];
        }
        if (!(lmax > 0.0)) continue;  // skip empty-target slices (ref quirk)
        // PSNR on own-max-normalized slices (float64 IEEE semantics match
        // numpy's: /0 -> inf/nan propagate into the mean like the oracle)
        long double sq = 0.0L;
        const double linv = 1.0 / lmax, ginv = 1.0 / gmax;
        for (long j = 0; j < n; ++j) {
            const double dlt = li[j] * linv - gi[j] * ginv;
            sq += dlt * dlt;
        }
        const double mse = static_cast<double>(sq / n);
        psnr_acc += 10.0 * std::log10(4.0 / mse);

        // SSIM on the raw slice (ssim_mean's math, preallocated buffers)
        for (long j = 0; j < n; ++j) {
            ux[j] = li[j];
            uy[j] = gi[j];
            uxx[j] = li[j] * li[j];
            uyy[j] = gi[j] * gi[j];
            uxy[j] = li[j] * gi[j];
        }
        double* fields[5] = {ux.data(), uy.data(), uxx.data(), uyy.data(),
                             uxy.data()};
        double* spare = scratch.data();
        for (int axis = 0; axis < 2; ++axis) {
            for (double*& f : fields) {
                box_filter_axis(f, spare, dims, 2, axis, win);
                std::swap(f, spare);
            }
        }
        long double acc = 0.0L;
        for (long r = pad; r < h - pad; ++r) {
            const long row = r * w;
            for (long cidx = pad; cidx < w - pad; ++cidx) {
                const long idx = row + cidx;
                const double mx = fields[0][idx], my = fields[1][idx];
                const double vx = cov_norm * (fields[2][idx] - mx * mx);
                const double vy = cov_norm * (fields[3][idx] - my * my);
                const double vxy = cov_norm * (fields[4][idx] - mx * my);
                const double a1 = 2.0 * mx * my + c1;
                const double a2 = 2.0 * vxy + c2;
                const double b1 = mx * mx + my * my + c1;
                const double b2 = vx + vy + c2;
                acc += (a1 * a2) / (b1 * b2);
            }
        }
        ssim_acc += acc / ((h - 2 * pad) * (w - 2 * pad));
        ++count;
    }
    out3[0] = static_cast<double>(psnr_acc / count);
    out3[1] = static_cast<double>(ssim_acc / count);
    out3[2] = static_cast<double>(count);
}

// One pass over two float64 arrays: writes {mean((a-b)^2), mean(|a-b|)} —
// the PSNR and MAE moments (utils/metrics.py psnr/mae) without numpy's
// temporary allocations.
void err_stats(const double* a, const double* b, long n, double* out2) {
    long double sq = 0.0L, ab = 0.0L;
    for (long i = 0; i < n; ++i) {
        const double d = a[i] - b[i];
        sq += d * d;
        ab += d < 0 ? -d : d;
    }
    out2[0] = static_cast<double>(sq / n);
    out2[1] = static_cast<double>(ab / n);
}

}  // extern "C"
