// Fused filtered leaky ReLU, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel afcm_tpu/ops/pallas/filtered_lrelu_mxu.py
// (filtered_lrelu_mxu -> _build_mxu_call.fwd_kernel, :273-290). Per (n, c)
// plane it computes, exactly as the plain composition of
// afcm_tpu_torch/ops/cuda/filtered_lrelu.py:filtered_lrelu_plain:
//
//   + bias -> zero-stuff by `up` -> pad (negative = crop) -> separable
//   up-FIR (W then H, taps pre-scaled by `up` per axis, i.e. gain up^2)
//   -> x gain -> leaky ReLU (strict > 0) -> clamp +-clamp -> separable
//   down-FIR (H then W) decimated by `down`.
//
// What bounds it. The plain composition writes and re-reads the 2x-rate
// intermediates (up to 612^2 per channel on the shipped generator) through
// device memory, four times per call. This kernel reads x once and writes y
// once; the intermediates live only in shared memory. What is left is fp32
// FMA issue and shared-memory traffic: four FIR passes over a tile, about
// 22 FMAs per mid sample. The shared memory moves 128 bytes a clock on an SM
// against four warp-wide FMAs, so a pass that loads more than a quarter of
// a sample per FMA is bound by it. The design:
//
// * One instantiation per filter geometry (up, down, taps) of the shipped
//   generator: 2/2 12/12, 2/4 12/24 and 4/2 24/12. Every tap loop unrolls,
//   a tap is a constant-bank operand of its FMA (the taps ride in the
//   kernel's parameters), and the polyphase start of an output is a
//   compile-time property of its position in a thread's chunk. Every other
//   geometry takes the generic kernel, whose loops have run-time bounds;
//   the caller chooses, and neither stands in for the other.
// * Register blocking along the FIR axis: a thread makes a chunk of eight
//   consecutive outputs from a window of samples held in registers, about
//   0.2 shared loads per FMA in the up passes and 0.27 in the strided down
//   passes, plus one store per output. In a pass along W the lanes of a warp
//   take neighbouring rows and every row pitch is odd; in a pass along H they
//   take neighbouring columns: no bank conflicts, in the strided passes
//   either.
// * Rectangular tiles up to 112 KB of dynamic shared memory, which keeps two
//   CTAs per SM. The caller plans the tile (ops/cuda/filtered_lrelu.py:
//   plan_fwd_tile), choosing by the FMAs of all tiles, and this file checks
//   the plan against its own formulas.
// * The x window comes in with every load of a thread in flight at once
//   (load_window), not row after row.
//
// The FMA order of the up passes is the one K2 (filtered_lrelu_bwd.cu)
// recomputes the pre-activation in: the bias added on load, the W pass
// before the H pass, taps ascending from the polyphase start, one fused
// multiply-add each. So the activation here sees the value K2's mask sees.
// The down passes run H then W, taps ascending.
//
// Design per CTA, for an output tile of Ty x Tx pixels (per axis, T):
//   mid window  M = (T - 1) * down + ntd, from mid index o0 * down
//               (o0 = the tile's first output)
// Generic kernel:
//   x window    L = ceil((M + ntu - 2) / up) + 1
//   bufA: x [Ly][Lx] -> the activated mid [My][Mx]
//   bufB: W-up [Ly][Mx] -> the H-down result [Ty][Mx]
// Specialised kernel: the up passes start rho = (o0 * down - pad0) mod up
// mid samples left of the window, so that buffer column 0 is at phase 0, and
// make E = ceil((M + up - 1) / 8) * 8 samples per axis in whole chunks:
//   x window    L = E / up - 8 / up + (the x samples a chunk reads)
//   bufA: x [Ly][Lx'] -> the activated mid [Ey][Mx'] -> the output [Ty][Tx']
//   bufB: W-up [Ly][Ex'] -> the H-down result [Ty][Mx']
// with odd pitches v' = v | 1. T is a multiple of 8 (the strided chunk).
//
// Interface: plain C, loaded with ctypes; launches on the caller's stream
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <stddef.h>

#define AFCM_MAX_TAPS 64
#define AFCM_THREADS 256       // the generic kernel's CTA; a specialised one has its own
#define AFCM_ROWS (AFCM_THREADS / 32)
#define AFCM_LOADS 8           // window elements a thread of it has in flight
#define AFCM_CHUNK 8           // outputs per thread and chunk of a specialised pass
#define AFCM_MAX_SMEM (226 * 1024)   // dynamic bytes of one CTA; the caller plans for two per SM

namespace {

struct Params {
    const void* x;
    const void* bias;      // nullptr = no bias; same dtype as x
    void* y;
    int channels, in_h, in_w, out_h, out_w;
    int up, down, ntu, ntd;
    int px0, py0;
    float gain, slope, clamp;
    int has_clamp;
    int tile_y, tile_x;    // output tile T
    int mid_y, mid_x;      // M
    int in_y, in_x;        // L
    int ext_y, ext_x;      // E (specialised; = M in the generic kernel)
    int pitch_lx, pitch_ex, pitch_mx, pitch_tx;   // floats per row of an [.][Lx], [.][Ex], ... buffer
    int tiles_x;
    int buf_a;             // floats in bufA
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

// Polyphase up pass from a chunk start at phase 0: output i of the chunk
// starts at tap k0(i) and at window sample off(i) and has taps(i) taps;
// window() is the count of samples a chunk of `chunk` outputs reads.
__host__ __device__ constexpr int up_k0(int i, int up) { return pos_mod(-i, up); }
__host__ __device__ constexpr int up_off(int i, int up) { return (i + up_k0(i, up)) / up; }
__host__ __device__ constexpr int up_taps(int i, int up, int ntu) {
    return (ntu - up_k0(i, up) + up - 1) / up;
}
__host__ __device__ constexpr int up_window(int up, int ntu, int chunk) {
    int w = 0;
    for (int i = 0; i < chunk; ++i)
        w = up_off(i, up) + up_taps(i, up, ntu) > w ? up_off(i, up) + up_taps(i, up, ntu) : w;
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

// A rows x cols window of a plane at (y0, x0) -> shared memory at `pitch`
// floats a row, `add` inside the image and zeros outside. The elements are
// dealt to the CTA's threads in row-major order, and a thread has LOADS of
// them in flight before it stores the first, so the loads of a whole window
// of up to THREADS * LOADS elements overlap.
template <int THREADS, int LOADS, typename T>
__device__ __forceinline__ void load_window(float* __restrict__ dst, int rows, int cols,
                                            int pitch, const T* __restrict__ src, int y0,
                                            int x0, int h, int w, float add, int tid) {
    const int dc = THREADS / cols, df = THREADS - dc * cols;
    const int step_src = dc * w + df, step_dst = dc * pitch + df;
    int c = tid / cols, f = tid - c * cols;     // row and column in the window
    int gy = y0 + c, gx = x0 + f;
    int from = gy * w + gx, to = c * pitch + f;
    while (c < rows) {
        float v[LOADS];
        int at[LOADS];
#pragma unroll
        for (int u = 0; u < LOADS; ++u) {
            v[u] = 0.f;
            at[u] = c < rows ? to : -1;
            if (c < rows && static_cast<unsigned>(gy) < static_cast<unsigned>(h) &&
                static_cast<unsigned>(gx) < static_cast<unsigned>(w))
                v[u] = load_f32(src + from) + add;
            f += df, gx += df, c += dc, gy += dc, from += step_src, to += step_dst;
            if (f >= cols)
                f -= cols, gx -= cols, ++c, ++gy, from += w - cols, to += pitch - cols;
        }
#pragma unroll
        for (int u = 0; u < LOADS; ++u)
            if (at[u] >= 0) dst[at[u]] = v[u];
    }
}

// Gain, leaky ReLU (strict > 0) and clamp of a pre-activation.
__device__ __forceinline__ float activate(float acc, float gain, float slope, float clamp,
                                          int has_clamp) {
    float v = (acc > 0.f ? acc : acc * slope) * gain;
    if (has_clamp) v = fminf(fmaxf(v, -clamp), clamp);
    return v;
}

// ---------------------------------------------------------------------------
// The generic kernel: any geometry, run-time loop bounds, one output per
// thread and step. Threads form a 32 x 8 grid: lanes walk the columns of a
// stage, warps its rows, so row-dependent indices are warp-uniform.
template <typename T>
__global__ void __launch_bounds__(AFCM_THREADS)
filtered_lrelu_fwd_kernel(const Params p) {
    extern __shared__ float smem[];
    __shared__ float s_gu[AFCM_MAX_TAPS];
    __shared__ float s_gd[AFCM_MAX_TAPS];
    float* __restrict__ buf_a = smem;
    float* __restrict__ buf_b = smem + p.buf_a;

    const int tx = threadIdx.x, ty = threadIdx.y;      // 32 x AFCM_ROWS
    const int plane = blockIdx.x;                       // n * C + c
    const int tile_y = blockIdx.y / p.tiles_x;
    const int tile_x = blockIdx.y - tile_y * p.tiles_x;
    const int Ty = p.tile_y, Tx = p.tile_x, My = p.mid_y, Mx = p.mid_x;
    const int Ly = p.in_y, Lx = p.in_x;
    const int oy0 = tile_y * Ty, ox0 = tile_x * Tx;
    const int up = p.up, down = p.down, ntu = p.ntu, ntd = p.ntd;

    const int tid = ty * 32 + tx;
    for (int i = tid; i < ntu; i += AFCM_THREADS) s_gu[i] = p.gu[i];
    for (int i = tid; i < ntd; i += AFCM_THREADS) s_gd[i] = p.gd[i];

    // Zero-stuffed index of the first mid sample's tap 0, per axis: mid[m]
    // = sum_k g[k] * stuffed[m + k - pad0]; stuffed[s] = x[s / up] where
    // s % up == 0, else 0.
    const int sy0 = oy0 * down - p.py0, sx0 = ox0 * down - p.px0;
    const int iy0 = floor_div(sy0, up), ix0 = floor_div(sx0, up);

    const T* __restrict__ x = static_cast<const T*>(p.x) +
                              static_cast<size_t>(plane) * p.in_h * p.in_w;
    const float b = p.bias == nullptr ? 0.f :
        load_f32(static_cast<const T*>(p.bias) + plane % p.channels);

    // 1. Input window (+ bias inside the image, zeros outside) -> bufA [Ly][Lx].
    load_window<AFCM_THREADS, AFCM_LOADS>(buf_a, Ly, Lx, Lx, x, iy0, ix0, p.in_h, p.in_w, b,
                                          tid);
    __syncthreads();

    // 2. Up-FIR along W -> bufB [Ly][Mx]. Column m meets the non-stuffed
    // samples at taps k0, k0 + up, ...; x index (s + k0) / up - ix0 + j.
    for (int m = tx; m < Mx; m += 32) {
        const int s = sx0 + m;
        const int k0 = pos_mod(-s, up);
        const int base = (s + k0) / up - ix0;
        for (int r = ty; r < Ly; r += AFCM_ROWS) {
            const float* row = buf_a + r * Lx + base;
            float acc = 0.f;
            for (int k = k0, j = 0; k < ntu; k += up, ++j) acc = fmaf(s_gu[k], row[j], acc);
            buf_b[r * Mx + m] = acc;
        }
    }
    __syncthreads();

    // 3. Up-FIR along H, then gain, leaky ReLU and clamp -> bufA [My][Mx].
    for (int r = ty; r < My; r += AFCM_ROWS) {
        const int s = sy0 + r;
        const int k0 = pos_mod(-s, up);
        const float* col0 = buf_b + ((s + k0) / up - iy0) * Mx;
        for (int m = tx; m < Mx; m += 32) {
            const float* col = col0 + m;
            float acc = 0.f;
            for (int k = k0, j = 0; k < ntu; k += up, ++j) acc = fmaf(s_gu[k], col[j * Mx], acc);
            buf_a[r * Mx + m] = activate(acc, p.gain, p.slope, p.clamp, p.has_clamp);
        }
    }
    __syncthreads();

    // 4. Down-FIR along H at stride `down` -> bufB [Ty][Mx].
    for (int r = ty; r < Ty; r += AFCM_ROWS) {
        const float* col0 = buf_a + r * down * Mx;
        for (int m = tx; m < Mx; m += 32) {
            float acc = 0.f;
            for (int k = 0; k < ntd; ++k) acc = fmaf(s_gd[k], col0[k * Mx + m], acc);
            buf_b[r * Mx + m] = acc;
        }
    }
    __syncthreads();

    // 5. Down-FIR along W at stride `down`, store the output tile.
    T* __restrict__ y = static_cast<T*>(p.y) +
                        static_cast<size_t>(plane) * p.out_h * p.out_w;
    for (int r = ty; r < Ty; r += AFCM_ROWS) {
        const int gy = oy0 + r;
        if (gy >= p.out_h) break;
        for (int q = tx; q < Tx; q += 32) {
            const int gx = ox0 + q;
            if (gx >= p.out_w) break;
            const float* row = buf_b + r * Mx + q * down;
            float acc = 0.f;
            for (int k = 0; k < ntd; ++k) acc = fmaf(s_gd[k], row[k], acc);
            store_f32(y + static_cast<size_t>(gy) * p.out_w + gx, acc);
        }
    }
}

// ---------------------------------------------------------------------------
// The specialised kernel: compile-time geometry, register blocking.

template <int U, int DN, int NTU, int NTD>
struct Geometry {
    static constexpr int CH = AFCM_CHUNK;  // outputs per thread of a polyphase pass
    static constexpr int RB = AFCM_CHUNK;  // outputs per thread of a strided pass
    static_assert(CH % U == 0, "a chunk starts at phase 0");
    static constexpr int WINU = up_window(U, NTU, CH);
    static constexpr int WIND = (RB - 1) * DN + NTD;
    // The CTA: eight warps, two CTAs per SM (128 registers a thread).
    // LOADS: the loads a thread has in flight while the window comes in;
    // THREADS * LOADS covers the largest window of a planned tile.
    static constexpr int THREADS = 256;
    static constexpr int LOADS = 20;
};

template <typename T, int U, int DN, int NTU, int NTD>
__global__ void __launch_bounds__((Geometry<U, DN, NTU, NTD>::THREADS), 2)
filtered_lrelu_fwd_spec_kernel(const Params p) {
    using G = Geometry<U, DN, NTU, NTD>;
    constexpr int CH = G::CH, RB = G::RB, THREADS = G::THREADS;
    constexpr int WINU = G::WINU, WIND = G::WIND;
    extern __shared__ float smem[];
    float* __restrict__ buf_a = smem;
    float* __restrict__ buf_b = smem + p.buf_a;

    const int tid = threadIdx.y * 32 + threadIdx.x;
    const int plane = blockIdx.x;                       // n * C + c
    const int tile_y = blockIdx.y / p.tiles_x;
    const int tile_x = blockIdx.y - tile_y * p.tiles_x;
    const int Ty = p.tile_y, Tx = p.tile_x, Mx = p.mid_x;
    const int Lxp = p.pitch_lx, Exp = p.pitch_ex, Mxp = p.pitch_mx, Txp = p.pitch_tx;
    const int oy0 = tile_y * Ty, ox0 = tile_x * Tx;

    // Zero-stuffed index of the tile's first mid sample's tap 0, per axis,
    // and the shift rho that puts buffer column 0 at phase 0: buffer column
    // j is tile mid column j - rho, its stuffed index s0 - rho + j.
    const int sy0 = oy0 * DN - p.py0, sx0 = ox0 * DN - p.px0;
    const int rho_y = pos_mod(sy0, U), rho_x = pos_mod(sx0, U);
    const int iy0 = floor_div(sy0 - rho_y, U), ix0 = floor_div(sx0 - rho_x, U);

    const T* __restrict__ x = static_cast<const T*>(p.x) +
                              static_cast<size_t>(plane) * p.in_h * p.in_w;
    const float b = p.bias == nullptr ? 0.f :
        load_f32(static_cast<const T*>(p.bias) + plane % p.channels);

    // 1. Input window (+ bias inside the image, zeros outside) -> bufA [Ly][Lxp].
    load_window<THREADS, G::LOADS>(buf_a, p.in_y, p.in_x, Lxp, x, iy0, ix0, p.in_h, p.in_w,
                                   b, tid);
    __syncthreads();

    // 2. Up-FIR along W -> bufB [Ly][Exp]: buffer column c * CH + i takes
    // taps k0(i), k0(i) + up, ... at x columns c * CH / up + off(i) + j.
    // Lanes on rows.
    for (Items<THREADS> it(p.in_y, tid); it.c < p.ext_x / CH; it.next()) {
        const int r = it.f, c = it.c;
        const float* row = buf_a + r * Lxp + c * (CH / U);
        float w[WINU];
#pragma unroll
        for (int t = 0; t < WINU; ++t) w[t] = row[t];
        float* out = buf_b + r * Exp + c * CH;
#pragma unroll
        for (int i = 0; i < CH; ++i) {
            float acc = 0.f;
#pragma unroll
            for (int k = up_k0(i, U), j = 0; k < NTU; k += U, ++j)
                acc = fmaf(p.gu[k], w[up_off(i, U) + j], acc);
            out[i] = acc;
        }
    }
    __syncthreads();

    // 3. Up-FIR along H over the Mx columns the tile needs, then gain, leaky
    // ReLU and clamp -> bufA [Ey][Mxp]. Lanes on columns.
    for (Items<THREADS> it(Mx, tid); it.c < p.ext_y / CH; it.next()) {
        const int m = it.f, c = it.c;
        const float* col = buf_b + c * (CH / U) * Exp + rho_x + m;
        float w[WINU];
#pragma unroll
        for (int t = 0; t < WINU; ++t) w[t] = col[t * Exp];
        float* out = buf_a + c * CH * Mxp + m;
#pragma unroll
        for (int i = 0; i < CH; ++i) {
            float acc = 0.f;
#pragma unroll
            for (int k = up_k0(i, U), j = 0; k < NTU; k += U, ++j)
                acc = fmaf(p.gu[k], w[up_off(i, U) + j], acc);
            out[i * Mxp] = activate(acc, p.gain, p.slope, p.clamp, p.has_clamp);
        }
    }
    __syncthreads();

    // 4. Down-FIR along H at stride `down`: output row c * RB + i takes mid
    // rows (i * down + k), k ascending -> bufB [Ty][Mxp]. Lanes on columns.
    for (Items<THREADS> it(Mx, tid); it.c < Ty / RB; it.next()) {
        const int m = it.f, c = it.c;
        const float* col = buf_a + (rho_y + c * RB * DN) * Mxp + m;
        float w[WIND];
#pragma unroll
        for (int t = 0; t < WIND; ++t) w[t] = col[t * Mxp];
        float* out = buf_b + c * RB * Mxp + m;
#pragma unroll
        for (int i = 0; i < RB; ++i) {
            float acc = 0.f;
#pragma unroll
            for (int k = 0; k < NTD; ++k) acc = fmaf(p.gd[k], w[i * DN + k], acc);
            out[i * Mxp] = acc;
        }
    }
    __syncthreads();

    // 5. Down-FIR along W at stride `down` -> the output tile in bufA
    // [Ty][Txp]. Lanes on rows.
    for (Items<THREADS> it(Ty, tid); it.c < Tx / RB; it.next()) {
        const int r = it.f, c = it.c;
        const float* row = buf_b + r * Mxp + c * RB * DN;
        float w[WIND];
#pragma unroll
        for (int t = 0; t < WIND; ++t) w[t] = row[t];
        float* out = buf_a + r * Txp + c * RB;
#pragma unroll
        for (int i = 0; i < RB; ++i) {
            float acc = 0.f;
#pragma unroll
            for (int k = 0; k < NTD; ++k) acc = fmaf(p.gd[k], w[i * DN + k], acc);
            out[i] = acc;
        }
    }
    __syncthreads();

    // 6. Store the tile, lanes along W.
    T* __restrict__ y = static_cast<T*>(p.y) +
                        static_cast<size_t>(plane) * p.out_h * p.out_w;
    for (int r = threadIdx.y; r < Ty; r += THREADS / 32) {
        const int gy = oy0 + r;
        if (gy >= p.out_h) break;
        for (int q = threadIdx.x; q < Tx; q += 32) {
            const int gx = ox0 + q;
            if (gx >= p.out_w) break;
            store_f32(y + static_cast<size_t>(gy) * p.out_w + gx, buf_a[r * Txp + q]);
        }
    }
}

// The caller's plan against this file's formulas; fills the derived fields.
bool accept_plan(Params& p, int spec, int smem_bytes) {
    const int ty = p.tile_y, tx = p.tile_x, up = p.up, down = p.down;
    if (ty < 1 || tx < 1 || (spec && (ty % AFCM_CHUNK != 0 || tx % AFCM_CHUNK != 0 ||
                                      AFCM_CHUNK % up != 0)))
        return false;
    const int my = (ty - 1) * down + p.ntd, mx = (tx - 1) * down + p.ntd;
    int ey = my, ex = mx, ly, lx;
    if (spec) {
        ey = (my + up - 1 + AFCM_CHUNK - 1) / AFCM_CHUNK * AFCM_CHUNK;
        ex = (mx + up - 1 + AFCM_CHUNK - 1) / AFCM_CHUNK * AFCM_CHUNK;
        const int reach = up_window(up, p.ntu, AFCM_CHUNK) - AFCM_CHUNK / up;
        ly = ey / up + reach;
        lx = ex / up + reach;
    } else {
        ly = (my + p.ntu - 2 + up - 1) / up + 1;
        lx = (mx + p.ntu - 2 + up - 1) / up + 1;
    }
    if (p.mid_y != my || p.mid_x != mx || p.in_y != ly || p.in_x != lx) return false;
    p.ext_y = ey;
    p.ext_x = ex;
    p.pitch_lx = spec ? (lx | 1) : lx;        // odd pitches: no bank conflicts
    p.pitch_ex = spec ? (ex | 1) : ex;        // when lanes take neighbouring rows
    p.pitch_mx = spec ? (mx | 1) : mx;
    p.pitch_tx = spec ? (tx | 1) : tx;
    long long a = static_cast<long long>(ly) * p.pitch_lx;
    const long long mid = static_cast<long long>(ey) * p.pitch_mx;
    const long long out = spec ? static_cast<long long>(ty) * p.pitch_tx : 0;
    a = a > mid ? a : mid;
    a = a > out ? a : out;
    const long long wup = static_cast<long long>(ly) * p.pitch_ex;
    const long long hdown = static_cast<long long>(ty) * p.pitch_mx;
    const long long floats = a + (wup > hdown ? wup : hdown);
    p.buf_a = static_cast<int>(a);
    return floats * 4 == smem_bytes && smem_bytes <= AFCM_MAX_SMEM;
}

template <typename Kernel>
int launch(Kernel kernel, int threads, const Params& p, int planes, int smem_bytes,
           cudaStream_t stream) {
    if (smem_bytes > 48 * 1024 - 2 * AFCM_MAX_TAPS * static_cast<int>(sizeof(float))) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int tiles_y = (p.out_h + p.tile_y - 1) / p.tile_y;
    if (static_cast<long long>(tiles_y) * p.tiles_x > 65535)
        return static_cast<int>(cudaErrorInvalidConfiguration);
    dim3 grid(planes, tiles_y * p.tiles_x);
    kernel<<<grid, dim3(32, threads / 32), smem_bytes, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

// The geometries (up, down, up taps, down taps) with an instantiation of the
// specialised kernel: the one list behind the dispatch and behind
// afcm_filtered_lrelu_fwd_geometries, which the caller's planner is held to.
#define AFCM_SPEC_GEOMETRIES(X) X(2, 2, 12, 12) X(2, 4, 12, 24) X(4, 2, 24, 12)

template <typename T>
int dispatch(const Params& p, int spec, int planes, int smem_bytes, cudaStream_t stream) {
    if (!spec)
        return launch(filtered_lrelu_fwd_kernel<T>, AFCM_THREADS, p, planes, smem_bytes, stream);
#define AFCM_LAUNCH_SPEC(U, D, NU, ND)                                                \
    if (p.up == U && p.down == D && p.ntu == NU && p.ntd == ND)                       \
        return launch(filtered_lrelu_fwd_spec_kernel<T, U, D, NU, ND>,                \
                      Geometry<U, D, NU, ND>::THREADS, p, planes, smem_bytes, stream);
    AFCM_SPEC_GEOMETRIES(AFCM_LAUNCH_SPEC)
#undef AFCM_LAUNCH_SPEC
    return static_cast<int>(cudaErrorInvalidValue);     // no such instantiation
}

}  // namespace

extern "C" {

// Writes (up, down, up taps, down taps) of every specialised instantiation,
// as far as `capacity` geometries fit `out`, and returns how many there are.
int afcm_filtered_lrelu_fwd_geometries(int* out, int capacity) {
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

// dtype: 0 = float32, 1 = bfloat16. fu/fd are host arrays of correlation-
// order taps (the caller flips and scales them). Padding px0/py0 is w.r.t.
// the upsampled image; the trailing pads are implied by out_h/out_w.
// tile_y, tile_x, mid_y, mid_x, in_y, in_x and smem_bytes are the caller's
// plan (T, M and L per axis and the dynamic shared memory); spec = 1 asks
// for the instantiation of this geometry and fails if there is none,
// spec = 0 for the generic kernel.
int afcm_filtered_lrelu_fwd(const void* x, const void* bias, void* y, int dtype,
                            int n, int channels, int in_h, int in_w,
                            int out_h, int out_w, const float* fu, int ntu,
                            const float* fd, int ntd, int up, int down,
                            int px0, int py0, float gain, float slope,
                            float clamp, int has_clamp, int tile_y, int tile_x,
                            int mid_y, int mid_x, int in_y, int in_x,
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
    p.y = y;
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
    p.tile_y = tile_y;
    p.tile_x = tile_x;
    p.mid_y = mid_y;
    p.mid_x = mid_x;
    p.in_y = in_y;
    p.in_x = in_x;
    if (!accept_plan(p, spec, smem_bytes)) return static_cast<int>(cudaErrorInvalidValue);
    p.tiles_x = (out_w + tile_x - 1) / tile_x;
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
