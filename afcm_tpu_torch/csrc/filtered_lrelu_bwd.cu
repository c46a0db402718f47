// Fused filtered leaky ReLU, backward (input gradient), for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel afcm_tpu/ops/pallas/filtered_lrelu_mxu.py
// (_build_mxu_call.bwd_kernel, :292-323, called by bwd_call :364-379 behind
// the custom_vjp at :485-495). Given x, the bias and dy = dL/dy of the
// forward of csrc/filtered_lrelu.cu, it writes dx = dL/d(x + bias), per
// (n, c) plane:
//
//   b    = up-FIR(zero-stuff(x + bias))          the forward's pre-activation
//   mask = gain where b > 0 (strict), else slope * gain; times 0 where the
//          activated value lies outside [-clamp, clamp] (inclusive bounds)
//   dx   = up-FIR^T( mask * down-FIR^T(dy) )
//
// down-FIR^T is an up-FIR by `down` with the down taps reversed; up-FIR^T
// is a down-FIR by `up` with the up taps reversed. The bias gradient (dx
// summed over N, H, W) is left to the caller, as the JAX package leaves it
// to XLA (filtered_lrelu_mxu.py:444-445).
//
// What bounds it. Like the forward, the plain composition writes and
// re-reads 2x-rate intermediates through device memory (the autograd graph
// of the composition also keeps them alive from the forward). This kernel
// reads x and dy once and writes dx once; b is recomputed in shared memory
// from x rather than stored, so the forward saves only its input. It is
// bound by fp32 FMA issue and shared-memory reads. It is the simple design:
// one CTA per (plane, dx tile), every stage a loop over the tile in shared
// memory, fp32 taps and accumulation. Tensor-core banded products (wgmma),
// TMA and persistent CTAs are later work.
//
// Design per CTA, for a dx tile of T x T input pixels (per axis):
//   mid window  M = (T - 1) * up + ntu, starting at mid index
//               m0 = t0 * up + pad0 - (ntu - 1) (t0 = the tile's first pixel)
//   x window    L = ceil((M + ntu - 2) / up) + 1   (as the forward's planner)
//   dy window   D = (M + ntd - 2) / down + 1
//   bufA: x [L][L]    -> later dy [D][D]
//   bufB: W-up [L][M] -> later W-pass of dy [D][M] -> later H-down [T][M]
//   bufM: mask [M][M] -> times the H-pass of dy: d(pre-activation)
// Stages 1-3 recompute b with the forward's loops and FMA order, so the
// mask sees the value the forward's activation saw. Mid positions the
// forward never computed get da = 0 from the zero dy outside the image, so
// their mask does not matter. The host picks T per call so that shared
// memory stays within 48 KB, minimizing the work of all tiles.
//
// Interface: plain C, loaded with ctypes; launches on the caller's stream
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <stddef.h>

#define AFCM_MAX_TAPS 64
#define AFCM_THREADS 256
#define AFCM_ROWS (AFCM_THREADS / 32)

namespace {

struct Params {
    const void* x;
    const void* bias;      // nullptr = no bias; same dtype as x
    const void* dy;
    void* dx;
    int channels, in_h, in_w, out_h, out_w;
    int up, down, ntu, ntd;
    int px0, py0;
    float gain, slope, clamp;
    int has_clamp;
    int tile;              // dx tile edge T
    int mid;               // M
    int in_tile;           // L
    int dy_tile;           // D
    int tiles_x;
    int buf_a;             // floats in bufA
    int buf_b;             // floats in bufB
    float gu[AFCM_MAX_TAPS];   // correlation-order up taps, x up
    float gd[AFCM_MAX_TAPS];   // correlation-order down taps
};

template <typename T> __device__ __forceinline__ float load_f32(const T* p);
template <> __device__ __forceinline__ float load_f32<float>(const float* p) {
    return *p;
}
template <> __device__ __forceinline__ float load_f32<__nv_bfloat16>(
        const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}

template <typename T> __device__ __forceinline__ void store_f32(T* p, float v);
template <> __device__ __forceinline__ void store_f32<float>(float* p, float v) {
    *p = v;
}
template <> __device__ __forceinline__ void store_f32<__nv_bfloat16>(
        __nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
}

__host__ __device__ __forceinline__ int floor_div(int a, int b) {
    int q = a / b;
    return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int pos_mod(int a, int b) {
    int r = a % b;
    return r < 0 ? r + b : r;
}

// Threads form a 32 x 8 grid: lanes walk the columns of a stage, warps its
// rows, as in the forward kernel.
template <typename T>
__global__ void __launch_bounds__(AFCM_THREADS)
filtered_lrelu_bwd_kernel(const Params p) {
    extern __shared__ float smem[];
    __shared__ float s_gu[AFCM_MAX_TAPS];
    __shared__ float s_gd[AFCM_MAX_TAPS];
    float* __restrict__ buf_a = smem;
    float* __restrict__ buf_b = smem + p.buf_a;
    float* __restrict__ buf_m = buf_b + p.buf_b;

    const int tx = threadIdx.x, ty = threadIdx.y;      // 32 x AFCM_ROWS
    const int plane = blockIdx.x;                       // n * C + c
    const int tile_y = blockIdx.y / p.tiles_x;
    const int tile_x = blockIdx.y - tile_y * p.tiles_x;
    const int tile = p.tile, M = p.mid, L = p.in_tile, D = p.dy_tile;
    const int ty0 = tile_y * tile, tx0 = tile_x * tile;  // first dx pixel
    const int up = p.up, down = p.down, ntu = p.ntu, ntd = p.ntd;

    const int tid = ty * 32 + tx;
    for (int i = tid; i < ntu; i += AFCM_THREADS) s_gu[i] = p.gu[i];
    for (int i = tid; i < ntd; i += AFCM_THREADS) s_gd[i] = p.gd[i];

    // First mid index of the window, per axis, and the zero-stuffed index
    // of its tap 0: mid[m] = sum_k g[k] * stuffed[m + k - pad0].
    const int my0 = ty0 * up + p.py0 - (ntu - 1);
    const int mx0 = tx0 * up + p.px0 - (ntu - 1);
    const int sy0 = my0 - p.py0, sx0 = mx0 - p.px0;
    const int iy0 = floor_div(sy0, up), ix0 = floor_div(sx0, up);
    // First dy index whose down taps reach the window: ceil((m0 - ntd + 1) / down).
    const int oy0 = floor_div(my0 - ntd + down, down);
    const int ox0 = floor_div(mx0 - ntd + down, down);

    const size_t in_plane = static_cast<size_t>(plane) * p.in_h * p.in_w;
    const T* __restrict__ x = static_cast<const T*>(p.x) + in_plane;
    const T* __restrict__ dy = static_cast<const T*>(p.dy) +
                               static_cast<size_t>(plane) * p.out_h * p.out_w;
    const float b = p.bias == nullptr ? 0.f :
        load_f32(static_cast<const T*>(p.bias) + plane % p.channels);

    // 1. Input window (+ bias inside the image, zeros outside) -> bufA [L][L].
    for (int r = ty; r < L; r += AFCM_ROWS) {
        const int gy = iy0 + r;
        const bool row_in = gy >= 0 && gy < p.in_h;
        for (int q = tx; q < L; q += 32) {
            const int gx = ix0 + q;
            float v = 0.f;
            if (row_in && gx >= 0 && gx < p.in_w)
                v = load_f32(x + static_cast<size_t>(gy) * p.in_w + gx) + b;
            buf_a[r * L + q] = v;
        }
    }
    __syncthreads();

    // 2. Up-FIR along W -> bufB [L][M] (the forward's stage 2).
    for (int m = tx; m < M; m += 32) {
        const int s = sx0 + m;
        const int k0 = pos_mod(-s, up);
        const int base = (s + k0) / up - ix0;
        for (int r = ty; r < L; r += AFCM_ROWS) {
            const float* row = buf_a + r * L + base;
            float acc = 0.f;
            for (int k = k0, j = 0; k < ntu; k += up, ++j) acc += s_gu[k] * row[j];
            buf_b[r * M + m] = acc;
        }
    }
    __syncthreads();

    // 3. Up-FIR along H (the forward's stage 3) -> the activation's
    // derivative in bufM [M][M]. Meanwhile the dy window -> bufA [D][D],
    // zeros outside dy.
    for (int r = ty; r < M; r += AFCM_ROWS) {
        const int s = sy0 + r;
        const int k0 = pos_mod(-s, up);
        const float* col0 = buf_b + ((s + k0) / up - iy0) * M;
        for (int m = tx; m < M; m += 32) {
            const float* col = col0 + m;
            float acc = 0.f;
            for (int k = k0, j = 0; k < ntu; k += up, ++j) acc += s_gu[k] * col[j * M];
            float d = acc > 0.f ? p.gain : p.slope * p.gain;
            if (p.has_clamp) {
                const float v = (acc > 0.f ? acc : acc * p.slope) * p.gain;
                if (!(v >= -p.clamp && v <= p.clamp)) d = 0.f;
            }
            buf_m[r * M + m] = d;
        }
    }
    for (int r = ty; r < D; r += AFCM_ROWS) {
        const int gy = oy0 + r;
        const bool row_in = gy >= 0 && gy < p.out_h;
        for (int q = tx; q < D; q += 32) {
            const int gx = ox0 + q;
            float v = 0.f;
            if (row_in && gx >= 0 && gx < p.out_w)
                v = load_f32(dy + static_cast<size_t>(gy) * p.out_w + gx);
            buf_a[r * D + q] = v;
        }
    }
    __syncthreads();

    // 4. down-FIR^T along W: da[m] = sum over o*down + k = m of gd[k] dy[o],
    // polyphase from k0 = m mod down, o stepping down -> bufB [D][M].
    for (int m = tx; m < M; m += 32) {
        const int g = mx0 + m;
        const int k0 = pos_mod(g, down);
        const int base = (g - k0) / down - ox0;
        for (int r = ty; r < D; r += AFCM_ROWS) {
            const float* row = buf_a + r * D + base;
            float acc = 0.f;
            for (int k = k0, j = 0; k < ntd; k += down, ++j) acc += s_gd[k] * row[-j];
            buf_b[r * M + m] = acc;
        }
    }
    __syncthreads();

    // 5. down-FIR^T along H, times the mask -> d(pre-activation), bufM in place.
    for (int r = ty; r < M; r += AFCM_ROWS) {
        const int g = my0 + r;
        const int k0 = pos_mod(g, down);
        const float* col0 = buf_b + ((g - k0) / down - oy0) * M;
        for (int m = tx; m < M; m += 32) {
            const float* col = col0 + m;
            float acc = 0.f;
            for (int k = k0, j = 0; k < ntd; k += down, ++j) acc += s_gd[k] * col[-j * M];
            buf_m[r * M + m] *= acc;
        }
    }
    __syncthreads();

    // 6. up-FIR^T along H at stride `up`: row q of the tile takes mid rows
    // q * up + ntu - 1 - k -> bufB [T][M].
    for (int r = ty; r < tile; r += AFCM_ROWS) {
        const float* col0 = buf_m + (r * up + ntu - 1) * M;
        for (int m = tx; m < M; m += 32) {
            float acc = 0.f;
            for (int k = 0; k < ntu; ++k) acc += s_gu[k] * col0[m - k * M];
            buf_b[r * M + m] = acc;
        }
    }
    __syncthreads();

    // 7. up-FIR^T along W at stride `up`, store the dx tile.
    T* __restrict__ dx = static_cast<T*>(p.dx) + in_plane;
    for (int r = ty; r < tile; r += AFCM_ROWS) {
        const int gy = ty0 + r;
        if (gy >= p.in_h) break;
        for (int q = tx; q < tile; q += 32) {
            const int gx = tx0 + q;
            if (gx >= p.in_w) break;
            const float* row = buf_b + r * M + q * up + ntu - 1;
            float acc = 0.f;
            for (int k = 0; k < ntu; ++k) acc += s_gu[k] * row[-k];
            store_f32(dx + static_cast<size_t>(gy) * p.in_w + gx, acc);
        }
    }
}

struct TilePlan {
    int tile, mid, in_tile, dy_tile, buf_a, buf_b, buf_m;
    double work;
};

TilePlan plan_tile(int t, int up, int down, int ntu, int ntd, int in_h,
                   int in_w) {
    TilePlan tp;
    tp.tile = t;
    tp.mid = (t - 1) * up + ntu;
    tp.in_tile = (tp.mid + ntu - 2 + up - 1) / up + 1;
    tp.dy_tile = (tp.mid + ntd - 2) / down + 1;
    const int L = tp.in_tile, M = tp.mid, D = tp.dy_tile;
    tp.buf_a = L * L > D * D ? L * L : D * D;
    int bb = L * M;
    if (D * M > bb) bb = D * M;
    if (t * M > bb) bb = t * M;
    tp.buf_b = bb;
    tp.buf_m = M * M;
    const double taps_up = (ntu + up - 1) / up;
    const double taps_down = (ntd + down - 1) / down;
    const double tiles = static_cast<double>((in_h + t - 1) / t) *
                         ((in_w + t - 1) / t);
    tp.work = tiles * (static_cast<double>(L) * M * taps_up +
                       static_cast<double>(M) * M * taps_up +
                       static_cast<double>(D) * M * taps_down +
                       static_cast<double>(M) * M * taps_down +
                       static_cast<double>(t) * M * ntu +
                       static_cast<double>(t) * t * ntu);
    return tp;
}

size_t plan_bytes(const TilePlan& tp) {
    return sizeof(float) * (static_cast<size_t>(tp.buf_a) + tp.buf_b + tp.buf_m);
}

template <typename T>
int launch(Params& p, int planes, cudaStream_t stream) {
    // 48 KB without opting in, shared with the static tap arrays.
    const size_t kDefaultSmem = 48 * 1024 - 2 * AFCM_MAX_TAPS * sizeof(float);
    TilePlan best{};
    bool found = false;
    for (int t = 4; t <= 64; t += 4) {
        TilePlan tp = plan_tile(t, p.up, p.down, p.ntu, p.ntd, p.in_h, p.in_w);
        if (plan_bytes(tp) > kDefaultSmem) continue;
        if (!found || tp.work < best.work) { best = tp; found = true; }
    }
    if (!found) best = plan_tile(4, p.up, p.down, p.ntu, p.ntd, p.in_h, p.in_w);
    const size_t bytes = plan_bytes(best);
    if (bytes > kDefaultSmem) {
        cudaError_t err = cudaFuncSetAttribute(
            filtered_lrelu_bwd_kernel<T>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    p.tile = best.tile;
    p.mid = best.mid;
    p.in_tile = best.in_tile;
    p.dy_tile = best.dy_tile;
    p.buf_a = best.buf_a;
    p.buf_b = best.buf_b;
    p.tiles_x = (p.in_w + best.tile - 1) / best.tile;
    const int tiles_y = (p.in_h + best.tile - 1) / best.tile;
    if (tiles_y * p.tiles_x > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
    dim3 grid(planes, tiles_y * p.tiles_x);
    filtered_lrelu_bwd_kernel<T><<<grid, dim3(32, AFCM_ROWS), bytes, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; x, bias, dy and dx share it. fu/fd are
// the host arrays of correlation-order taps the forward takes (the caller
// flips and scales them). Padding px0/py0 is w.r.t. the upsampled image;
// out_h/out_w are dy's (the forward's output) size.
int afcm_filtered_lrelu_bwd(const void* x, const void* bias, const void* dy,
                            void* dx, int dtype, int n, int channels,
                            int in_h, int in_w, int out_h, int out_w,
                            const float* fu, int ntu, const float* fd, int ntd,
                            int up, int down, int px0, int py0, float gain,
                            float slope, float clamp, int has_clamp,
                            void* stream) {
    if (ntu < 1 || ntu > AFCM_MAX_TAPS || ntd < 1 || ntd > AFCM_MAX_TAPS ||
        up < 1 || down < 1 || n < 1 || channels < 1 || in_h < 1 || in_w < 1 ||
        out_h < 1 || out_w < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    Params p = {};
    p.x = x;
    p.bias = bias;
    p.dy = dy;
    p.dx = dx;
    p.channels = channels;
    p.in_h = in_h;
    p.in_w = in_w;
    p.out_h = out_h;
    p.out_w = out_w;
    p.up = up;
    p.down = down;
    p.ntu = ntu;
    p.ntd = ntd;
    p.px0 = px0;
    p.py0 = py0;
    p.gain = gain;
    p.slope = slope;
    p.clamp = clamp;
    p.has_clamp = has_clamp;
    for (int k = 0; k < ntu; ++k) p.gu[k] = fu[k];
    for (int k = 0; k < ntd; ++k) p.gd[k] = fd[k];
    const long long planes = static_cast<long long>(n) * channels;
    if (planes > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch<float>(p, static_cast<int>(planes), s);
    if (dtype == 1) return launch<__nv_bfloat16>(p, static_cast<int>(planes), s);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
