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
// from x rather than stored, so the forward saves only its input. What is
// left is fp32 FMA issue and shared-memory reads: seven FIR passes over a
// tile in shared memory, about 130 FMAs per input pixel. The design spends
// as few instructions beside the FMAs as it can:
//
// * One instantiation per filter geometry (up, down, taps) of the shipped
//   generator: 2/2 12/12, 2/4 12/24 and 4/2 24/12. Every tap loop unrolls,
//   a tap is a constant-bank operand of its FMA (the taps ride in the
//   kernel's parameters), and the polyphase start of an output is a
//   compile-time property of its position in a thread's chunk. Every other
//   geometry takes the generic kernel, whose loops have run-time bounds;
//   the caller chooses, and neither stands in for the other.
// * Register blocking along the FIR axis: a thread makes a chunk of
//   consecutive outputs from a sliding window of samples held in registers,
//   0.2-0.4 shared loads per FMA instead of two. In a pass along W the
//   lanes of a warp take neighbouring rows and every row pitch is odd; in
//   a pass along H they take neighbouring columns: no bank conflicts.
// * Tiles up to 112 KB of dynamic shared memory, which keeps two CTAs per
//   SM; the longest filters (up 4, 24 taps) get T = 24 where 48 KB gave 12.
//   The caller plans the tile (ops/cuda/filtered_lrelu.py: plan_bwd_tile)
//   and this file checks the plan against its own formulas.
// * The x and dy windows come in with every load of a thread in flight at
//   once (load_window), not row block after row block. Counted per stage with
//   clock64, the two loads are still a quarter of a tile's time, and the
//   passes issue about five instructions per FMA (addresses, predicates,
//   the activation's derivative): that, not the FMA rate, is what is left.
//
// Design per CTA, for a dx tile of T x T input pixels (per axis):
//   mid window  M = (T - 1) * up + ntu, starting at mid index
//               m0 = t0 * up + pad0 - (ntu - 1) (t0 = the tile's first pixel)
//   x window    L = ceil((M + ntu - 2) / up) + 1   (as the forward's planner)
//   dy window   D = (M + ntd - 2) / down + 1
//   bufA: x [L][L]    -> later dy [D][D] -> later the dx tile [T][T]
//   bufB: W-up [L][M] -> later W-pass of dy [D][M] -> later H-down [T][M]
//   bufM: mask [M][M] -> times the H-pass of dy: d(pre-activation)
// Stages 1-3 recompute b in the forward's FMA order (taps ascending from
// the polyphase start, one fused multiply-add each, W pass then H pass, the
// bias added on load), so the mask sees the value the forward's activation
// saw. Mid positions the forward never computed get da = 0 from the zero dy
// outside the image, so their mask does not matter.
//
// The polyphase starts. With m0 as above the up phase of mid column m is
// (ntu - 1 - m) mod up, whatever the tile and the padding. The phase of the
// transposed down-FIR is (m0 + m) mod down, which depends on both; the
// passes over dy therefore cut their chunks sigma = m0 mod down columns to
// the left, so that a chunk starts at phase 0. A chunk's window may reach a
// few samples past a buffer's rows for outputs that are not stored; the
// buffers lie back to back between two slack areas so that such a read
// stays inside the CTA's shared memory.
//
// Interface: plain C, loaded with ctypes; launches on the caller's stream
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <stddef.h>

#define AFCM_MAX_TAPS 64
#define AFCM_THREADS 256       // the generic kernel's CTA; a specialised one has its own
#define AFCM_ROWS (AFCM_THREADS / 32)
#define AFCM_SLACK 64          // floats before bufA and after bufM
#define AFCM_LOADS 8           // window elements a thread of it has in flight
#define AFCM_MAX_SMEM (226 * 1024)   // dynamic bytes of one CTA; the caller plans for two per SM

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
    int pitch_l, pitch_m, pitch_d, pitch_t;    // floats per row of an [.][L], [.][M], ... buffer
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

__host__ __device__ constexpr int pos_mod(int a, int b) {
    return (a % b + b) % b;
}

// The tile's geometry, shared by both kernels.
struct Window {
    int ty0, tx0;          // first dx pixel
    int my0, mx0;          // first mid index of the window
    int iy0, ix0;          // first x index of the window
    int oy0, ox0;          // first dy index of the window
};

__device__ __forceinline__ Window tile_window(const Params& p) {
    Window w;
    const int tile_y = blockIdx.y / p.tiles_x;
    const int tile_x = blockIdx.y - tile_y * p.tiles_x;
    w.ty0 = tile_y * p.tile;
    w.tx0 = tile_x * p.tile;
    // First mid index of the window, per axis, and the zero-stuffed index
    // of its tap 0: mid[m] = sum_k g[k] * stuffed[m + k - pad0].
    w.my0 = w.ty0 * p.up + p.py0 - (p.ntu - 1);
    w.mx0 = w.tx0 * p.up + p.px0 - (p.ntu - 1);
    w.iy0 = floor_div(w.my0 - p.py0, p.up);
    w.ix0 = floor_div(w.mx0 - p.px0, p.up);
    // First dy index whose down taps reach the window: ceil((m0 - ntd + 1) / down).
    w.oy0 = floor_div(w.my0 - p.ntd + p.down, p.down);
    w.ox0 = floor_div(w.mx0 - p.ntd + p.down, p.down);
    return w;
}

// The items (f < nf, c < nc) of a pass, dealt to the CTA's threads with
// lanes on neighbouring f: for (Items<THREADS> it(nf, tid); it.c < nc; it.next()).
template <int THREADS>
struct Items {
    int nf, dc, df, c, f;
    __device__ __forceinline__ Items(int nf_, int tid)
        : nf(nf_), dc(THREADS / nf_), df(THREADS - dc * nf_), c(tid / nf_),
          f(tid - c * nf_) {}
    __device__ __forceinline__ void next() {
        f += df;
        c += dc;
        if (f >= nf) {
            f -= nf;
            ++c;
        }
    }
};

// A square window of a plane -> shared memory, `add` inside the image and
// zeros outside. The window's elements are dealt to the CTA's threads in
// row-major order, and a thread has LOADS of them in flight before it
// stores the first, so the loads of a whole window of up to THREADS * LOADS
// elements overlap. The walk carries the element's offsets in the
// plane and in the buffer along, a handful of integer instructions per load.
template <int THREADS, int LOADS, typename T>
__device__ __forceinline__ void load_window(float* __restrict__ dst, int size, int pitch,
                                            const T* __restrict__ src, int y0, int x0,
                                            int h, int w, float add, int tid) {
    const int dc = THREADS / size, df = THREADS - dc * size;
    const int step_src = dc * w + df, step_dst = dc * pitch + df;
    int c = tid / size, f = tid - c * size;     // row and column in the window
    int gy = y0 + c, gx = x0 + f;
    int from = gy * w + gx, to = c * pitch + f;
    while (c < size) {
        float v[LOADS];
        int at[LOADS];
#pragma unroll
        for (int u = 0; u < LOADS; ++u) {
            v[u] = 0.f;
            at[u] = c < size ? to : -1;
            if (c < size && static_cast<unsigned>(gy) < static_cast<unsigned>(h) &&
                static_cast<unsigned>(gx) < static_cast<unsigned>(w))
                v[u] = load_f32(src + from) + add;
            f += df, gx += df, c += dc, gy += dc, from += step_src, to += step_dst;
            if (f >= size)
                f -= size, gx -= size, ++c, ++gy, from += w - size, to += pitch - size;
        }
#pragma unroll
        for (int u = 0; u < LOADS; ++u)
            if (at[u] >= 0) dst[at[u]] = v[u];
    }
}

// The activation's derivative at pre-activation `acc`.
__device__ __forceinline__ float act_slope(float acc, float gain, float slope, float clamp,
                                           int has_clamp) {
    float d = acc > 0.f ? gain : slope * gain;
    if (has_clamp) {
        const float v = (acc > 0.f ? acc : acc * slope) * gain;
        if (!(v >= -clamp && v <= clamp)) d = 0.f;
    }
    return d;
}

// ---------------------------------------------------------------------------
// The generic kernel: any geometry, run-time loop bounds, one output per
// thread and step. Threads form a 32 x 8 grid: lanes walk the columns of a
// stage, warps its rows, as in the forward kernel.
template <typename T>
__global__ void __launch_bounds__(AFCM_THREADS)
filtered_lrelu_bwd_kernel(const Params p) {
    extern __shared__ float smem[];
    __shared__ float s_gu[AFCM_MAX_TAPS];
    __shared__ float s_gd[AFCM_MAX_TAPS];
    float* __restrict__ buf_a = smem + AFCM_SLACK;
    float* __restrict__ buf_b = buf_a + p.buf_a;
    float* __restrict__ buf_m = buf_b + p.buf_b;

    const int tx = threadIdx.x, ty = threadIdx.y;      // 32 x AFCM_ROWS
    const int plane = blockIdx.x;                       // n * C + c
    const int tile = p.tile, M = p.mid, L = p.in_tile, D = p.dy_tile;
    const int up = p.up, down = p.down, ntu = p.ntu, ntd = p.ntd;
    const Window win = tile_window(p);
    const int ty0 = win.ty0, tx0 = win.tx0, my0 = win.my0, mx0 = win.mx0;
    const int iy0 = win.iy0, ix0 = win.ix0, oy0 = win.oy0, ox0 = win.ox0;
    const int sy0 = my0 - p.py0, sx0 = mx0 - p.px0;

    const int tid = ty * 32 + tx;
    for (int i = tid; i < ntu; i += AFCM_THREADS) s_gu[i] = p.gu[i];
    for (int i = tid; i < ntd; i += AFCM_THREADS) s_gd[i] = p.gd[i];

    const size_t in_plane = static_cast<size_t>(plane) * p.in_h * p.in_w;
    const T* __restrict__ x = static_cast<const T*>(p.x) + in_plane;
    const T* __restrict__ dy = static_cast<const T*>(p.dy) +
                               static_cast<size_t>(plane) * p.out_h * p.out_w;
    const float b = p.bias == nullptr ? 0.f :
        load_f32(static_cast<const T*>(p.bias) + plane % p.channels);

    // 1. Input window (+ bias inside the image, zeros outside) -> bufA [L][L].
    load_window<AFCM_THREADS, AFCM_LOADS>(buf_a, L, L, x, iy0, ix0, p.in_h, p.in_w, b, tid);
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
            buf_m[r * M + m] = act_slope(acc, p.gain, p.slope, p.clamp, p.has_clamp);
        }
    }
    load_window<AFCM_THREADS, AFCM_LOADS>(buf_a, D, D, dy, oy0, ox0, p.out_h, p.out_w, 0.f, tid);
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

// ---------------------------------------------------------------------------
// The specialised kernel: compile-time geometry, register blocking.

// Up passes: output i of a chunk starts at tap k0 and at window sample off.
template <int U, int NTU>
struct UpPhase {
    static constexpr int CU = (NTU - 1 + U - 1) / U;       // ceil((ntu - 1) / up)
    __host__ __device__ static constexpr int k0(int i) { return pos_mod(NTU - 1 - i, U); }
    __host__ __device__ static constexpr int off(int i) {
        return (i + k0(i) - (NTU - 1)) / U + CU;           // the numerator divides by U
    }
    __host__ __device__ static constexpr int taps(int i) { return (NTU - k0(i) + U - 1) / U; }
    __host__ __device__ static constexpr int window(int chunk) {
        int w = 0;
        for (int i = 0; i < chunk; ++i) w = off(i) + taps(i) > w ? off(i) + taps(i) : w;
        return w;
    }
};

template <int U, int DN, int NTU, int NTD>
struct Geometry {
    static constexpr int CH = 8;       // outputs per thread of a polyphase pass
    static constexpr int RB = 4;       // outputs per thread of a strided pass
    static_assert(CH % U == 0 && CH % DN == 0, "a chunk starts at phase 0");
    static_assert(NTD % DN == 0, "the dy windows start at the first stored output's tap");
    static constexpr int TPD = (NTD + DN - 1) / DN;        // most taps of a down phase
    static constexpr int WINU = UpPhase<U, NTU>::window(CH);
    static constexpr int WIND = CH / DN + TPD - 1;
    static constexpr int WINT = (RB - 1) * U + NTU;
    // The CTA. The passes are bound by instruction issue, and twelve warps
    // fill the issue slots better than eight; with up = 4 the tile is small
    // enough for three CTAs of eight warps on an SM, which twelve warps'
    // registers would not allow. LOADS: the loads a thread has in flight
    // while a window comes in; THREADS * LOADS covers the largest window.
    static constexpr int THREADS = U == 4 ? 256 : 384;
    static constexpr int LOADS = U == 4 ? 8 : 12;
};

template <typename T, int U, int DN, int NTU, int NTD>
__global__ void __launch_bounds__((Geometry<U, DN, NTU, NTD>::THREADS), 2)
filtered_lrelu_bwd_spec_kernel(const Params p) {
    using G = Geometry<U, DN, NTU, NTD>;
    using UP = UpPhase<U, NTU>;
    constexpr int CH = G::CH, RB = G::RB, TPD = G::TPD, THREADS = G::THREADS;
    constexpr int WINU = G::WINU, WIND = G::WIND, WINT = G::WINT;
    extern __shared__ float smem[];
    float* __restrict__ buf_a = smem + AFCM_SLACK;
    float* __restrict__ buf_b = buf_a + p.buf_a;
    float* __restrict__ buf_m = buf_b + p.buf_b;

    const int tid = threadIdx.y * 32 + threadIdx.x;
    const int plane = blockIdx.x;                       // n * C + c
    const int tile = p.tile, M = p.mid, L = p.in_tile, D = p.dy_tile;
    const int Lp = p.pitch_l, Mp = p.pitch_m, Dp = p.pitch_d, Tp = p.pitch_t;
    const Window win = tile_window(p);

    const size_t in_plane = static_cast<size_t>(plane) * p.in_h * p.in_w;
    const T* __restrict__ x = static_cast<const T*>(p.x) + in_plane;
    const T* __restrict__ dy = static_cast<const T*>(p.dy) +
                               static_cast<size_t>(plane) * p.out_h * p.out_w;
    const float b = p.bias == nullptr ? 0.f :
        load_f32(static_cast<const T*>(p.bias) + plane % p.channels);

    // 1. Input window (+ bias inside the image, zeros outside) -> bufA [L][Lp].
    load_window<THREADS, G::LOADS>(buf_a, L, Lp, x, win.iy0, win.ix0, p.in_h, p.in_w, b, tid);
    __syncthreads();

    // 2. Up-FIR along W -> bufB [L][Mp], the forward's stage 2: mid column
    // c * CH + i takes taps k0(i), k0(i) + up, ... at x columns
    // c * CH / up + off(i) + j. Lanes on rows.
    const int chunks_up = (M + CH - 1) / CH;
    for (Items<THREADS> it(L, tid); it.c < chunks_up; it.next()) {
        const int r = it.f, c = it.c;
        const float* row = buf_a + r * Lp + c * (CH / U);
        float w[WINU];
#pragma unroll
        for (int t = 0; t < WINU; ++t) w[t] = row[t];
        float* out = buf_b + r * Mp + c * CH;
#pragma unroll
        for (int i = 0; i < CH; ++i) {
            float acc = 0.f;
#pragma unroll
            for (int k = UP::k0(i), j = 0; k < NTU; k += U, ++j)
                acc = fmaf(p.gu[k], w[UP::off(i) + j], acc);
            if (c * CH + i < M) out[i] = acc;
        }
    }
    __syncthreads();

    // 3. Up-FIR along H (the forward's stage 3) -> the activation's
    // derivative in bufM [M][Mp]. Lanes on columns. First the dy window
    // -> bufA [D][Dp], zeros outside dy.
    load_window<THREADS, G::LOADS>(buf_a, D, Dp, dy, win.oy0, win.ox0, p.out_h, p.out_w, 0.f, tid);
    for (Items<THREADS> it(M, tid); it.c < chunks_up; it.next()) {
        const int m = it.f, c = it.c;
        const float* col = buf_b + c * (CH / U) * Mp + m;
        float w[WINU];
#pragma unroll
        for (int t = 0; t < WINU; ++t) w[t] = col[t * Mp];
#pragma unroll
        for (int i = 0; i < CH; ++i) {
            float acc = 0.f;
#pragma unroll
            for (int k = UP::k0(i), j = 0; k < NTU; k += U, ++j)
                acc = fmaf(p.gu[k], w[UP::off(i) + j], acc);
            const int r = c * CH + i;
            if (r < M) buf_m[r * Mp + m] = act_slope(acc, p.gain, p.slope, p.clamp, p.has_clamp);
        }
    }
    __syncthreads();

    // 4. down-FIR^T along W: da[m] = sum over o*down + k = m of gd[k] dy[o]
    // -> bufB [D][Mp]. Chunks start sigma columns left of the window, at
    // phase 0: column c * CH - sigma + i takes taps i mod down, + down, ...
    // at dy columns first + c * CH / down + i / down - j. Lanes on rows.
    {
        const int sigma = pos_mod(win.mx0, DN);
        const int first = (win.mx0 - sigma) / DN - win.ox0 - (TPD - 1);
        for (Items<THREADS> it(D, tid); it.c < (M + sigma + CH - 1) / CH; it.next()) {
            const int r = it.f, c = it.c;
            const float* row = buf_a + r * Dp + first + c * (CH / DN);
            float w[WIND];
#pragma unroll
            for (int t = 0; t < WIND; ++t) w[t] = row[t];
            float* out = buf_b + r * Mp + c * CH - sigma;
#pragma unroll
            for (int i = 0; i < CH; ++i) {
                float acc = 0.f;
#pragma unroll
                for (int k = i % DN, j = 0; k < NTD; k += DN, ++j)
                    acc = fmaf(p.gd[k], w[i / DN - j + TPD - 1], acc);
                const int m = c * CH - sigma + i;
                if (m >= 0 && m < M) out[i] = acc;
            }
        }
    }
    __syncthreads();

    // 5. down-FIR^T along H, times the mask -> d(pre-activation), bufM in
    // place. Lanes on columns.
    {
        const int sigma = pos_mod(win.my0, DN);
        const int first = (win.my0 - sigma) / DN - win.oy0 - (TPD - 1);
        for (Items<THREADS> it(M, tid); it.c < (M + sigma + CH - 1) / CH; it.next()) {
            const int m = it.f, c = it.c;
            const float* col = buf_b + (first + c * (CH / DN)) * Mp + m;
            float w[WIND];
#pragma unroll
            for (int t = 0; t < WIND; ++t) w[t] = col[t * Mp];
#pragma unroll
            for (int i = 0; i < CH; ++i) {
                float acc = 0.f;
#pragma unroll
                for (int k = i % DN, j = 0; k < NTD; k += DN, ++j)
                    acc = fmaf(p.gd[k], w[i / DN - j + TPD - 1], acc);
                const int r = c * CH - sigma + i;
                if (r >= 0 && r < M) buf_m[r * Mp + m] *= acc;
            }
        }
    }
    __syncthreads();

    // 6. up-FIR^T along H at stride `up`: row q of the tile takes mid rows
    // q * up + ntu - 1 - k -> bufB [T][Mp]. T is a multiple of RB. Lanes on
    // columns.
    for (Items<THREADS> it(M, tid); it.c < tile / RB; it.next()) {
        const int m = it.f, c = it.c;
        const float* col = buf_m + c * (RB * U) * Mp + m;
        float w[WINT];
#pragma unroll
        for (int t = 0; t < WINT; ++t) w[t] = col[t * Mp];
#pragma unroll
        for (int i = 0; i < RB; ++i) {
            float acc = 0.f;
#pragma unroll
            for (int k = 0; k < NTU; ++k) acc = fmaf(p.gu[k], w[i * U + NTU - 1 - k], acc);
            buf_b[(c * RB + i) * Mp + m] = acc;
        }
    }
    __syncthreads();

    // 7. up-FIR^T along W at stride `up` -> the dx tile in bufA [T][Tp].
    // Lanes on rows.
    for (Items<THREADS> it(tile, tid); it.c < tile / RB; it.next()) {
        const int r = it.f, c = it.c;
        const float* row = buf_b + r * Mp + c * (RB * U);
        float w[WINT];
#pragma unroll
        for (int t = 0; t < WINT; ++t) w[t] = row[t];
#pragma unroll
        for (int i = 0; i < RB; ++i) {
            float acc = 0.f;
#pragma unroll
            for (int k = 0; k < NTU; ++k) acc = fmaf(p.gu[k], w[i * U + NTU - 1 - k], acc);
            buf_a[r * Tp + c * RB + i] = acc;
        }
    }
    __syncthreads();

    // 8. Store the tile, lanes along W.
    T* __restrict__ dx = static_cast<T*>(p.dx) + in_plane;
    for (int r = threadIdx.y; r < tile; r += THREADS / 32) {
        const int gy = win.ty0 + r;
        if (gy >= p.in_h) break;
        for (int q = threadIdx.x; q < tile; q += 32) {
            const int gx = win.tx0 + q;
            if (gx >= p.in_w) break;
            store_f32(dx + static_cast<size_t>(gy) * p.in_w + gx, buf_a[r * Tp + q]);
        }
    }
}

// The caller's plan against this file's formulas; fills the derived fields.
bool accept_plan(Params& p, int spec, int smem_bytes) {
    const int t = p.tile, up = p.up;
    if (t < 1 || (spec && t % 4 != 0)) return false;
    const int M = (t - 1) * up + p.ntu;
    const int L = (M + p.ntu - 2 + up - 1) / up + 1;
    const int D = (M + p.ntd - 2) / p.down + 1;
    if (p.mid != M || p.in_tile != L || p.dy_tile != D) return false;
    p.pitch_l = spec ? (L | 1) : L;           // odd pitches: no bank conflicts
    p.pitch_m = spec ? (M | 1) : M;           // when lanes take neighbouring rows
    p.pitch_d = spec ? (D | 1) : D;
    p.pitch_t = spec ? (t | 1) : t;
    const int la = L * p.pitch_l, da = D * p.pitch_d;
    p.buf_a = la > da ? la : da;
    int rows = L > D ? L : D;
    if (t > rows) rows = t;
    p.buf_b = rows * p.pitch_m;
    const long long floats = 2LL * AFCM_SLACK + p.buf_a + p.buf_b +
                             static_cast<long long>(M) * p.pitch_m;
    return floats * 4 == smem_bytes && smem_bytes <= AFCM_MAX_SMEM &&
           (!spec || (t * p.pitch_t <= p.buf_a && p.buf_a >= p.pitch_m));
}

template <typename Kernel>
int launch(Kernel kernel, int threads, const Params& p, int planes, int smem_bytes,
           cudaStream_t stream) {
    if (smem_bytes > 48 * 1024 - 2 * AFCM_MAX_TAPS * static_cast<int>(sizeof(float))) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int tiles_y = (p.in_h + p.tile - 1) / p.tile;
    if (tiles_y * p.tiles_x > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
    dim3 grid(planes, tiles_y * p.tiles_x);
    kernel<<<grid, dim3(32, threads / 32), smem_bytes, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

// The geometries (up, down, up taps, down taps) with an instantiation of the
// specialised kernel: the one list behind the dispatch and behind
// afcm_filtered_lrelu_bwd_geometries, which the caller's planner is held to.
#define AFCM_SPEC_GEOMETRIES(X) X(2, 2, 12, 12) X(2, 4, 12, 24) X(4, 2, 24, 12)

template <typename T>
int dispatch(const Params& p, int spec, int planes, int smem_bytes, cudaStream_t stream) {
    if (!spec)
        return launch(filtered_lrelu_bwd_kernel<T>, AFCM_THREADS, p, planes, smem_bytes, stream);
#define AFCM_LAUNCH_SPEC(U, D, NU, ND)                                                \
    if (p.up == U && p.down == D && p.ntu == NU && p.ntd == ND)                       \
        return launch(filtered_lrelu_bwd_spec_kernel<T, U, D, NU, ND>,                \
                      Geometry<U, D, NU, ND>::THREADS, p, planes, smem_bytes, stream);
    AFCM_SPEC_GEOMETRIES(AFCM_LAUNCH_SPEC)
#undef AFCM_LAUNCH_SPEC
    return static_cast<int>(cudaErrorInvalidValue);     // no such instantiation
}

}  // namespace

extern "C" {

// Writes (up, down, up taps, down taps) of every specialised instantiation,
// as far as `capacity` geometries fit `out`, and returns how many there are.
int afcm_filtered_lrelu_bwd_geometries(int* out, int capacity) {
    int count = 0;
#define AFCM_LIST_SPEC(U, D, NU, ND)                                  \
    if (count < capacity) {                                           \
        const int g[4] = {U, D, NU, ND};                              \
        for (int k = 0; k < 4; ++k) out[4 * count + k] = g[k];        \
    }                                                                 \
    ++count;
    AFCM_SPEC_GEOMETRIES(AFCM_LIST_SPEC)
#undef AFCM_LIST_SPEC
    return count;
}

// dtype: 0 = float32, 1 = bfloat16; x, bias, dy and dx share it. fu/fd are
// the host arrays of correlation-order taps the forward takes (the caller
// flips and scales them). Padding px0/py0 is w.r.t. the upsampled image;
// out_h/out_w are dy's (the forward's output) size. tile, mid, in_tile,
// dy_tile and smem_bytes are the caller's plan (T, M, L, D and the dynamic
// shared memory); spec = 1 asks for the instantiation of this geometry and
// fails if there is none, spec = 0 for the generic kernel.
int afcm_filtered_lrelu_bwd(const void* x, const void* bias, const void* dy,
                            void* dx, int dtype, int n, int channels,
                            int in_h, int in_w, int out_h, int out_w,
                            const float* fu, int ntu, const float* fd, int ntd,
                            int up, int down, int px0, int py0, float gain,
                            float slope, float clamp, int has_clamp,
                            int tile, int mid, int in_tile, int dy_tile,
                            int smem_bytes, int spec, void* stream) {
    if (ntu < 1 || ntu > AFCM_MAX_TAPS || ntd < 1 || ntd > AFCM_MAX_TAPS ||
        up < 1 || down < 1 || n < 1 || channels < 1 || in_h < 1 || in_w < 1 ||
        out_h < 1 || out_w < 1 ||
        static_cast<long long>(in_h) * in_w > 2147483647LL ||      // offsets in a plane
        static_cast<long long>(out_h) * out_w > 2147483647LL)      // are 32-bit
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
    p.tile = tile;
    p.mid = mid;
    p.in_tile = in_tile;
    p.dy_tile = dy_tile;
    if (!accept_plan(p, spec, smem_bytes)) return static_cast<int>(cudaErrorInvalidValue);
    p.tiles_x = (in_w + tile - 1) / tile;
    for (int k = 0; k < ntu; ++k) p.gu[k] = fu[k];
    for (int k = 0; k < ntd; ++k) p.gd[k] = fd[k];
    const long long planes = static_cast<long long>(n) * channels;
    if (planes > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return dispatch<float>(p, spec, static_cast<int>(planes), smem_bytes, s);
    if (dtype == 1)
        return dispatch<__nv_bfloat16>(p, spec, static_cast<int>(planes), smem_bytes, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
