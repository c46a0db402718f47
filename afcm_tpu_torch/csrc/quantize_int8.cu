// Symmetric int8 quantizers that feed the int8 3x3 convolution
// (conv_int8.cu), for NVIDIA Hopper (sm_90a).
//
// Replace the XLA ops around the TPU kernel's pallas_call in
// afcm_tpu/ops/pallas/conv_int8.py: the per-sample activation quantizer
// (:258-262) and the per-output-channel weight quantizer (:276-280), with
// the layout changes the conv kernel wants fused in. They compute what
// afcm_tpu_torch/ops/cuda/conv_int8.py's plain versions compute, bit for bit:
//
//   x_scale[n] = max(max|x[n]|, 1e-8) / 127
//   xq         = clip(rint(x / x_scale[n]), -127, 127)      (true division,
//                                                            round half even)
//   out        = int8 NHWC [N][H+2p][W+2p][I'] of xq with a zero halo of p
//                pixels and the channels padded to I' with zeros
//
//   w_scale[o] = max(max|w[o]|, 1e-12) / 127
//   out        = int8 [O'/64][I'/32][9][2][64][16] of
//                clip(rint(w / w_scale[o]), -127, 127): one contiguous block
//                per (64 output channels, 32 input channels), inside it tap
//                dy * 3 + dx, K chunk of 16 input channels, output channel,
//                input channel (the conv kernel's shared-memory order);
//                zeros beyond O and I
//
// Maxima are taken on the bits of |v| as unsigned integers. Non-negative
// floats order as their bits do, and a NaN's bits lie above infinity's: a
// maximum has no order, so the result is deterministic, and a NaN anywhere
// in a sample (or in a weight's output channel) makes its scale NaN, as the
// plain version's amax does, so the conv's whole sample (channel) comes out
// NaN and not finite but wrong.
//
// Interface: plain C, loaded with ctypes; launches on the caller's stream
// and returns cudaGetLastError(). afcm_tpu_torch/ops/cuda/conv_int8.py's
// plan_quantize_activations and plan_quantize_weights mirror the plans
// computed here; afcm_quantize_*_plan export them for the card's tests to
// hold the mirrors to.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <stddef.h>
#include <stdint.h>

#include "wgmma_s8.cuh"       // mbarriers and bulk copies

#define AFCM_Q8_THREADS 256
#define AFCM_Q8_CTAS_PER_SM 3   // the activation kernel's persistent CTAs
#define AFCM_Q8_GROUP 64        // channels of an activation quantize tile
#define AFCM_Q8_A_VECS 8        // 16-byte loads a thread makes in an amax tile

namespace {

constexpr int THREADS = AFCM_Q8_THREADS;
constexpr int WARPS = THREADS / 32;
constexpr int GROUP = AFCM_Q8_GROUP;
constexpr int A_VECS = AFCM_Q8_A_VECS;

static_assert(GROUP == 8 * 8, "a warp's lanes: 8 chunks of 8 channels x 4 along the plane");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// clip(rint(v / scale), -127, 127) of K values, each as a word whose low
// byte is the integer in two's complement; v / scale is the IEEE quotient
// (__fdiv_rn), rint rounds half to even. Adding 1.5 * 2^23 rounds half to
// even into the mantissa's low bits: no float-to-integer conversion.
//
// Under a finite scale, inv = RN(1 / scale) (__frcp_rn): no clamp or NaN
// test is needed, since |v| <= amax and scale >= amax / 127 * (1 - 2^-24)
// after its rounding, so |v / scale| < 127.5; and the quotients are divided
// only where their rounding to an integer can depend on it. With Q = v /
// scale exact, q = RN(v * inv) is within 2^-24 |Q| (inv's rounding) +
// 2^-24 |Q| (the product's) < 2^-16 of Q, and the IEEE quotient RN(Q)
// within 2^-17: they differ by less than 2^-15, so they round to the same
// integer unless q lies within 2^-15 of a half-integer. Where one of the K
// q lies within 2^-14 of one (|q - rint(q)| >= 0.5 - 2^-14: ties and near
// ties, about one value in 8,000 of a uniform spread), all K come from
// __fdiv_rn itself; elsewhere from rint(q), which equals rint(__fdiv_rn(v,
// scale)). inv is normal for every finite scale (7.9e-11 <= scale <=
// 2.7e36), a subnormal v gives a quotient that rounds to 0 either way, and
// the _rn intrinsics keep the compiler from contracting the product into
// the additions. tests/test_torch_quantizer_plans.py emulates this in
// float32 against the IEEE quotient.
//
// Otherwise (a NaN or infinite scale) every value is divided; the clamp
// goes first (the bounds are integers, so it commutes with rint), and a NaN
// quotient (a NaN scale, or v = inf over an infinite one) quantizes to 0:
// the scale carries the NaN to the conv's output.
template <int K>
__device__ __forceinline__ void quantize(const float (&v)[K], float scale, float inv, bool finite,
                                         uint32_t (&b)[K]) {
    constexpr float MAGIC = 12582912.f;          // 1.5 * 2^23
    if (finite) {
        bool near = false;
#pragma unroll
        for (int j = 0; j < K; ++j) {
            const float q = __fmul_rn(v[j], inv);
            const float t = __fadd_rn(q, MAGIC);
            near |= fabsf(__fsub_rn(q, __fsub_rn(t, MAGIC))) >= 0.5f - 0x1p-14f;
            b[j] = __float_as_uint(t);
        }
        if (near) {
#pragma unroll
            for (int j = 0; j < K; ++j)
                b[j] = __float_as_uint(__fadd_rn(__fdiv_rn(v[j], scale), MAGIC));
        }
        return;
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
        const float r = __fdiv_rn(v[j], scale);
        b[j] = r != r ? 0u : __float_as_uint(fminf(fmaxf(r, -127.f), 127.f) + MAGIC);
    }
}

// The low bytes of four words as one word, b0's lowest.
__device__ __forceinline__ uint32_t pack4(uint32_t b0, uint32_t b1, uint32_t b2, uint32_t b3) {
    return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040), 0x5410);
}

// The bits of |v|: they order as the non-negative floats do, NaN above all.
__device__ __forceinline__ unsigned abs_bits(float v) { return __float_as_uint(v) & 0x7fffffffu; }

// max(amax, floor) / 127 that keeps a NaN amax (fmaxf would drop it).
__device__ __forceinline__ float scale_of(unsigned amax_bits, float floor) {
    const float a = __uint_as_float(amax_bits);
    return __fdiv_rn(a < floor ? floor : a, 127.0f);
}

__device__ __forceinline__ unsigned warp_max(unsigned m) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, d));
    return m;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
    asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
    unsigned v;
    asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
    return v;
}

template <int Bytes> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = uint32_t; };
template <> struct Raw<2> { using type = uint16_t; };

// ---------------------------------------------------------------------------
// Activations: one persistent kernel, its work ordered by tickets.
//
// What bounds it: bytes. The amax of a sample must be known before any of
// its int8 bytes is written, so x is read twice; at batch 16 and 512
// channels the one-read bound (x once, the packed tensor and the scales
// once, / 3.35 TB/s) is 0.0103 / 0.0209 / 0.0106 ms at 36^2 p2 / 52^2 p2 /
// 38^2 p0 in bf16, the two-read bound 0.0166 / 0.0341 / 0.0177. The kernel
// it replaces made three launches (a memset, amax over the whole batch,
// then the quantizing pass), so its second read of a 44 MB batch came
// largely from device memory, and its quantizing loads were 2-byte scalars
// strided by H * W. Here the second read of each sample comes from L2:
//
// * Work items: A(n, t), the maximum of |x| over tile t of sample n (a range
//   of 32 KB read with 16-byte loads, the sample's unaligned ends with
//   scalar ones), merged into amax[n] with atomicMax on its bits, then a
//   fence and one arrival on done[n]; the last to arrive writes x_scale[n]
//   and publishes the scale's bits with the top bit set in ready[n] (a
//   scale's sign bit is clear). Q(n, t), the quantize tile t of
//   sample n: 64 channels x one pass of each warp along the plane (4 lanes
//   x V pixels, V * sizeof(x) = 16, 8, 4 or 2 bytes as the plane's size and
//   x's address allow), each lane 8 channels of V pixels: 8 vector loads,
//   issued before the wait for the scale (x does not change, and a tile's
//   time is mostly latency: the loads, the wait, the compute), then
//   quantized and packed in registers into V stores of 8 bytes, eight lanes
//   making a pixel's 64 channel bytes (whole 32-byte sectors). Its share of
//   the zero halo pixels is written in 16-byte stores, and the channel pad
//   as zeros: no memset of the output. The quantizing divides only near
//   ties (quantize above): a division per element made the quantize
//   tiles bound by the SMs' issue.
// * Order: the persistent CTAs claim tickets with atomicAdd, never by
//   blockIdx: A(0..L-1), then Q(k) and A(k + L) for k = 0, 1, ...; Q(k)
//   waits (an acquire load of ready[k], spinning in one thread) until every
//   A(k) tile has arrived. L is the number of samples whose amax tiles fill
//   the persistent CTAs once, plus one, so the first wave reads only x, and
//   a sample's x is still in the 50 MB L2 when its Q tiles read it again
//   (at most L samples, 14.6 MB at 36^2 bf16, 16.6 MB at 52^2, between a
//   sample's reads). Three CTAs an SM (85 registers a thread) were faster
//   than two or four, and 32 KB amax tiles faster than 16 or 48 KB (in
//   turns on an H100; PERF.md).
// * Why it cannot deadlock: A tiles never wait, and a Q tile waits only on
//   A tickets smaller than its own. A CTA claims its next ticket while it
//   works on the current one, so a ticket is either done, being worked on,
//   or held by a CTA whose current ticket is smaller still; the CTA with
//   the smallest current ticket therefore always makes progress. Nothing
//   needs the CTAs to be co-resident, and no cooperative launch.
// * Scratch (cleared by one cudaMemsetAsync): the ticket counter, done[N],
//   amax[N], ready[N]; each call allocates its own, so calls on two streams
//   do not share it.

struct ActPlan {
    int n, i, ip, h, w, p;
    int hw, wp, plane;          // H * W, W + 2p, (H + 2p) * (W + 2p)
    int vec;                    // pixels a lane loads at once (V)
    int chunks, groups;         // quantize tiles: plane chunks x channel groups
    int halo, halo_share;       // zero pixels of a plane, and per chunk
    long long count;            // elements of a sample
    int a_elems, ta, tq;        // amax tile elements; tiles per sample
    int lag;                    // L
    int grid;
    long long tickets;
};

// The ticket's work item: kind 0 = A, 1 = Q; sample; tile.
struct Item {
    int kind, n, tile;
};

__device__ __forceinline__ Item item_of(long long t, const ActPlan& pl) {
    const long long first = static_cast<long long>(pl.lag) * pl.ta;
    if (t < first) return {0, static_cast<int>(t / pl.ta), static_cast<int>(t % pl.ta)};
    t -= first;
    const int step = pl.ta + pl.tq;
    const long long both = static_cast<long long>(pl.n - pl.lag) * step;
    if (t < both) {
        const int k = static_cast<int>(t / step), r = static_cast<int>(t % step);
        return r < pl.tq ? Item{1, k, r} : Item{0, k + pl.lag, r - pl.tq};
    }
    t -= both;
    return {1, pl.n - pl.lag + static_cast<int>(t / pl.tq), static_cast<int>(t % pl.tq)};
}

template <typename T>
__device__ void amax_tile(const T* __restrict__ x, unsigned* amax, unsigned* done,
                          unsigned* ready, float* __restrict__ x_scale, const ActPlan& pl, int n,
                          int tile, unsigned* s_max) {
    const int tid = threadIdx.x;
    const T* xs = x + n * pl.count;
    const long long e0 = static_cast<long long>(tile) * pl.a_elems;
    const long long e1 = min(e0 + pl.a_elems, pl.count);
    // [e0, e1) = scalar head, 16-byte vectors, scalar tail
    constexpr int PER = 16 / sizeof(T);
    const uintptr_t a0 = reinterpret_cast<uintptr_t>(xs + e0);
    long long head = static_cast<long long>(((16 - a0 % 16) % 16) / sizeof(T));
    head = min(head, e1 - e0);
    const long long nvec = (e1 - e0 - head) / PER;
    const long long tail0 = e0 + head + nvec * PER;
    unsigned m = 0u;
    const uint4* xv = reinterpret_cast<const uint4*>(xs + e0 + head);
    uint4 v[A_VECS];
#pragma unroll
    for (int k = 0; k < A_VECS; ++k) {
        const long long j = tid + static_cast<long long>(k) * THREADS;
        v[k] = j < nvec ? xv[j] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < A_VECS; ++k) {
        const T* t = reinterpret_cast<const T*>(&v[k]);
#pragma unroll
        for (int j = 0; j < PER; ++j) m = max(m, abs_bits(to_f32(t[j])));
    }
    for (long long j = tid; j < head; j += THREADS) m = max(m, abs_bits(to_f32(xs[e0 + j])));
    for (long long j = tail0 + tid; j < e1; j += THREADS) m = max(m, abs_bits(to_f32(xs[j])));
    m = warp_max(m);
    if ((tid & 31) == 0) atomicMax(s_max, m);
    __syncthreads();
    if (tid == 0) {
        atomicMax(amax + n, *s_max);
        *s_max = 0u;
        __threadfence();                        // the maximum, before the arrival
        if (atomicAdd(done + n, 1u) == static_cast<unsigned>(pl.ta) - 1u) {
            __threadfence();                    // every tile's maximum, before the read
            const float scale = scale_of(ld_relaxed(amax + n), 1e-8f);
            x_scale[n] = scale;
            st_release(ready + n, (__float_as_uint(scale) & 0x7fffffffu) | 0x80000000u);
        }
    }
}

// Output pixel (row-major over the padded plane) of zero pixel `idx`: the
// top p rows, then 2p pixels of each image row, then the bottom p rows.
__device__ __forceinline__ int halo_pixel(int idx, const ActPlan& pl) {
    const int top = pl.p * pl.wp, side = pl.h * 2 * pl.p;
    if (idx < top) return idx;
    idx -= top;
    if (idx < side) {
        const int r = pl.p + idx / (2 * pl.p), s = idx % (2 * pl.p);
        return r * pl.wp + (s < pl.p ? s : pl.w + s);
    }
    return (pl.p + pl.h) * pl.wp + (idx - side);
}

// Quantize V pixels of 8 channels and store each pixel's 8 bytes.
template <typename T, typename R, int V>
__device__ __forceinline__ void quantize_store(const R (&raw)[8], float scale, int8_t* dst, int hh,
                                               int ww, const ActPlan& pl) {
    const bool finite = isfinite(scale);
    const float inv = finite ? __frcp_rn(scale) : 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
        float f[8];
        uint32_t b[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = to_f32(reinterpret_cast<const T*>(&raw[j])[v]);
        quantize<8>(f, scale, inv, finite, b);
        *reinterpret_cast<uint2*>(dst + static_cast<size_t>((hh + pl.p) * pl.wp + ww + pl.p) *
                                            pl.ip) =
            make_uint2(pack4(b[0], b[1], b[2], b[3]), pack4(b[4], b[5], b[6], b[7]));
        if (++ww == pl.w) {
            ww = 0;
            ++hh;
        }
    }
}

template <typename T, int V>
__device__ void quantize_tile(const T* __restrict__ x, const unsigned* ready,
                              int8_t* __restrict__ out, const ActPlan& pl, int n, int tile,
                              float* s_scale) {
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int chunk = tile % pl.chunks, group = tile / pl.chunks;
    int8_t* outs = out + static_cast<size_t>(n) * pl.plane * pl.ip;
    // x does not change: its loads go out before the wait for the scale
    const int c = group * GROUP + (lane & 7) * 8;
    const int q0 = ((chunk * WARPS + warp) * 4 + (lane >> 3)) * V;
    const bool active = c < pl.ip && q0 < pl.hw;
    using R = typename Raw<V * sizeof(T)>::type;
    const T* src = x + (static_cast<size_t>(n) * pl.i + c) * pl.hw + q0;
    R raw[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)      // channels >= I hold zeros, which quantize to 0
        raw[j] = active && c + j < pl.i
                     ? *reinterpret_cast<const R*>(src + static_cast<size_t>(j) * pl.hw)
                     : R{};
    {   // this tile's share of the halo, 64 channels a pixel: no wait needed
        const int h0 = chunk * pl.halo_share;
        const int cnt = max(0, min(pl.halo_share, pl.halo - h0));
        for (int e = tid; e < cnt * 4; e += THREADS) {
            const int cz = group * GROUP + (e & 3) * 16;
            if (cz < pl.ip)
                *reinterpret_cast<uint4*>(
                    outs + static_cast<size_t>(halo_pixel(h0 + (e >> 2), pl)) * pl.ip + cz) =
                    make_uint4(0u, 0u, 0u, 0u);
        }
    }
    if (tid == 0) {     // the scale, published with its top bit set by the last amax tile
        unsigned v;
        while (!((v = ld_acquire(ready + n)) & 0x80000000u)) __nanosleep(32);
        *s_scale = __uint_as_float(v & 0x7fffffffu);
    }
    __syncthreads();
    if (!active) return;
    const int hh = q0 / pl.w, ww = q0 - hh * pl.w;
    quantize_store<T, R, V>(raw, *s_scale, outs + c, hh, ww, pl);
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS, AFCM_Q8_CTAS_PER_SM)
quantize_activations_kernel(const T* __restrict__ x, unsigned* scratch,
                            float* __restrict__ x_scale, int8_t* __restrict__ out,
                            const ActPlan pl) {
    __shared__ long long s_ticket[2];
    __shared__ unsigned s_max;
    __shared__ float s_scale;
    unsigned* ticket = scratch;
    unsigned* done = scratch + 1;
    unsigned* amax = done + pl.n;
    unsigned* ready = amax + pl.n;
    const int tid = threadIdx.x;
    if (tid == 0) {
        s_ticket[0] = atomicAdd(ticket, 1u);
        s_max = 0u;
    }
    __syncthreads();
    int buf = 0;
    long long t = s_ticket[0];
    while (t < pl.tickets) {
        unsigned next = 0u;
        if (tid == 0) next = atomicAdd(ticket, 1u);   // its latency hides under this tile
        const Item it = item_of(t, pl);
        if (it.kind == 0) amax_tile<T>(x, amax, done, ready, x_scale, pl, it.n, it.tile, &s_max);
        else quantize_tile<T, V>(x, ready, out, pl, it.n, it.tile, &s_scale);
        if (tid == 0) s_ticket[buf ^ 1] = next;
        __syncthreads();
        buf ^= 1;
        t = s_ticket[buf];
    }
}

ActPlan plan_activations(int n, int i, int ip, int h, int w, int p, int elem, uintptr_t x,
                         int sms) {
    ActPlan pl{};
    pl.n = n; pl.i = i; pl.ip = ip; pl.h = h; pl.w = w; pl.p = p;
    pl.hw = h * w;
    pl.wp = w + 2 * p;
    pl.plane = (h + 2 * p) * pl.wp;
    pl.vec = 1;
    for (int v = 16 / elem; v > 1; v >>= 1)
        if (pl.hw % v == 0 && x % (static_cast<uintptr_t>(v) * elem) == 0) {
            pl.vec = v;
            break;
        }
    const int passes = (pl.hw + 4 * pl.vec - 1) / (4 * pl.vec);
    pl.chunks = (passes + WARPS - 1) / WARPS;
    pl.groups = (ip + GROUP - 1) / GROUP;
    pl.tq = pl.chunks * pl.groups;
    pl.halo = pl.plane - pl.hw;
    pl.halo_share = (pl.halo + pl.chunks - 1) / pl.chunks;
    pl.count = static_cast<long long>(i) * pl.hw;
    pl.a_elems = THREADS * A_VECS * 16 / elem;
    pl.ta = static_cast<int>((pl.count + pl.a_elems - 1) / pl.a_elems);
    pl.tickets = static_cast<long long>(n) * (pl.ta + pl.tq);
    pl.grid = static_cast<int>(min(pl.tickets, static_cast<long long>(sms) * AFCM_Q8_CTAS_PER_SM));
    pl.lag = min(n, (pl.grid + pl.ta - 1) / pl.ta + 1);
    return pl;
}

template <typename T, int V>
cudaError_t launch_activations_v(const T* x, unsigned* scratch, float* x_scale, int8_t* out,
                                 const ActPlan& pl, cudaStream_t stream) {
    quantize_activations_kernel<T, V><<<pl.grid, THREADS, 0, stream>>>(x, scratch, x_scale, out,
                                                                       pl);
    return cudaGetLastError();
}

template <typename T>
int launch_activations(const T* x, unsigned* scratch, float* x_scale, int8_t* out, int n, int i,
                       int ip, int h, int w, int p, cudaStream_t stream) {
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const ActPlan pl = plan_activations(n, i, ip, h, w, p, sizeof(T),
                                        reinterpret_cast<uintptr_t>(x), sms);
    err = cudaMemsetAsync(scratch, 0, sizeof(unsigned) * (3 * n + 1), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int bytes = pl.vec * static_cast<int>(sizeof(T));     // a lane's load
    const auto launch = bytes == 16 ? launch_activations_v<T, 16 / sizeof(T)>
                        : bytes == 8 ? launch_activations_v<T, 8 / sizeof(T)>
                        : bytes == 4 ? launch_activations_v<T, 4 / sizeof(T)>
                                     : launch_activations_v<T, 1>;
    err = launch(x, scratch, x_scale, out, pl, stream);
    return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// Weights: 16-byte runs.
//
// What bounds it: bytes, the float weights read once and the packed tensor
// written once: 0.0035 ms at 512 x 512 float32 (3.35 TB/s). The kernel it
// replaces took one 256-thread CTA per output channel, read its 18 KB and
// paid two block barriers before writing, then stored every int8 byte on
// its own (2.36 M one-byte stores at 512 x 512, the pad channels too).
//
// * One CTA an output channel (O' of them, one wave at the routed widths:
//   every row's load in flight at once). A CTA that took two or four rows,
//   one after the other behind their bulk copies, was slower on an H100
//   (PERF.md). The row's I * 9 values come into shared memory by one bulk
//   copy on an mbarrier where the row's bytes and address are multiples of
//   16, else by plain loads.
// * The 256 threads take the row's maximum (merged by a shared atomicMax),
//   then each quantizes runs of 16 input channels of one tap and writes
//   each as one 16-byte store, dividing only near ties (quantize above).
//   The pad channels (o >= O) and inputs (i >= I) are written as zeros by
//   the same stores.

struct WPlan {
    int o, op, i, ip;
    int smem;                   // dynamic shared memory: the mbarrier, the row
    int bulk;                   // the row comes by a bulk copy
};

constexpr int W_BAR_BYTES = 16;                 // the mbarrier, padded to the row's alignment
constexpr int SMEM_LIMIT = 232448;              // a CTA's shared memory on sm_90

WPlan plan_weights(int o, int op, int i, int ip, int elem, uintptr_t w) {
    WPlan pl{};
    pl.o = o; pl.op = op; pl.i = i; pl.ip = ip;
    const int row = i * 9 * elem;
    pl.smem = W_BAR_BYTES + row;
    pl.bulk = row % 16 == 0 && w % 16 == 0;
    return pl;
}

// Byte offset of (tap, output channel o, input channel i) in the tiled
// weights; kb_count = I' / 32.
__device__ __forceinline__ size_t tiled_offset(int tap, int o, int i, int kb_count) {
    const int mb = o >> 6, m = o & 63, kb = i >> 5, kc = (i >> 4) & 1, b = i & 15;
    return ((((static_cast<size_t>(mb) * kb_count + kb) * 9 + tap) * 2 + kc) * 64 + m) * 16 + b;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
quantize_weights_kernel(const T* __restrict__ w, float* __restrict__ w_scale,
                        int8_t* __restrict__ out, const WPlan pl) {
    extern __shared__ __align__(16) unsigned char smem[];
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
    T* row = reinterpret_cast<T*>(smem + W_BAR_BYTES);
    __shared__ unsigned s_max;
    const int tid = threadIdx.x, o = blockIdx.x;
    const bool real = o < pl.o;                 // else a pad channel: zeros
    const int row_elems = pl.i * 9;
    const T* src = w + static_cast<size_t>(o) * row_elems;
    if (tid == 0) s_max = 0u;
    if (real && pl.bulk && tid == 0) {
        afcm::mbar_init(bar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        afcm::mbar_expect_tx(bar, row_elems * sizeof(T));
        afcm::bulk_load(smem + W_BAR_BYTES, src, row_elems * sizeof(T), bar);
    } else if (real && !pl.bulk) {
        for (int e = tid; e < row_elems; e += THREADS) row[e] = src[e];
    }
    __syncthreads();
    float scale = 1.f;
    if (real) {
        if (pl.bulk) afcm::mbar_wait(bar, 0);
        unsigned m = 0u;
        for (int e = tid; e < row_elems; e += THREADS) m = max(m, abs_bits(to_f32(row[e])));
        m = warp_max(m);
        if ((tid & 31) == 0) atomicMax(&s_max, m);
        __syncthreads();
        scale = scale_of(s_max, 1e-12f);
        if (tid == 0) w_scale[o] = scale;
    }
    // runs of 16 input channels: item = run * 9 + tap
    const int kb_count = pl.ip >> 5, items = (pl.ip >> 4) * 9;
    const bool finite = isfinite(scale);
    const float inv = finite ? __frcp_rn(scale) : 0.f;
    for (int e = tid; e < items; e += THREADS) {
        const int tap = e % 9, i0 = (e / 9) * 16;
        float f[16];
        uint32_t b[16];
#pragma unroll
        for (int j = 0; j < 16; ++j)
            f[j] = real && i0 + j < pl.i ? to_f32(row[(i0 + j) * 9 + tap]) : 0.f;
        quantize<16>(f, scale, inv, finite, b);
        *reinterpret_cast<uint4*>(out + tiled_offset(tap, o, i0, kb_count)) =
            make_uint4(pack4(b[0], b[1], b[2], b[3]), pack4(b[4], b[5], b[6], b[7]),
                       pack4(b[8], b[9], b[10], b[11]), pack4(b[12], b[13], b[14], b[15]));
    }
}

template <typename T>
int launch_weights(const T* w, float* w_scale, int8_t* out, int o, int op, int i, int ip,
                   cudaStream_t stream) {
    const WPlan pl = plan_weights(o, op, i, ip, sizeof(T), reinterpret_cast<uintptr_t>(w));
    // + s_max, static shared memory rounded up to 16 bytes
    if (pl.smem + 16 > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
    if (pl.smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            quantize_weights_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    quantize_weights_kernel<T><<<pl.op, THREADS, pl.smem, stream>>>(w, w_scale, out, pl);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x: [n][i][h][w] contiguous; scratch:
// 3n + 1 32-bit words; x_scale: float [n]; out: int8 [n][h+2p][w+2p][ip],
// ip % 32 == 0, ip >= i. One kernel launch (after a memset of the
// scratch); every byte of out is written.
int afcm_quantize_activations(const void* x, void* scratch, void* x_scale, void* out, int dtype,
                              int n, int i, int ip, int h, int w, int p, void* stream) {
    if (n < 1 || i < 1 || ip < i || ip % 32 != 0 || h < 1 || w < 1 || p < 0 ||
        static_cast<long long>(n) * i * h * w >= (1LL << 40))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    unsigned* sc = static_cast<unsigned*>(scratch);
    float* xs = static_cast<float*>(x_scale);
    int8_t* o8 = static_cast<int8_t*>(out);
    if (dtype == 0)
        return launch_activations(static_cast<const float*>(x), sc, xs, o8, n, i, ip, h, w, p, st);
    if (dtype == 1)
        return launch_activations(static_cast<const __nv_bfloat16*>(x), sc, xs, o8, n, i, ip, h,
                                  w, p, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

// w: [o][i][3][3] contiguous; w_scale: float [o]; out: int8
// [op/64][ip/32][9][2][64][16], op >= o, op % 64 == 0, ip % 32 == 0,
// ip >= i. Every byte of out is written.
int afcm_quantize_weights(const void* w, void* w_scale, void* out, int dtype, int o, int op,
                          int i, int ip, void* stream) {
    if (o < 1 || op < o || op % 64 != 0 || i < 1 || ip < i || ip % 32 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* ws = static_cast<float*>(w_scale);
    int8_t* o8 = static_cast<int8_t*>(out);
    if (dtype == 0) return launch_weights(static_cast<const float*>(w), ws, o8, o, op, i, ip, st);
    if (dtype == 1)
        return launch_weights(static_cast<const __nv_bfloat16*>(w), ws, o8, o, op, i, ip, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

// The plans the two entry points above launch with, for
// afcm_tpu_torch/ops/cuda/conv_int8.py's plan_quantize_activations and
// plan_quantize_weights to be held to. info: ActivationPlan's fields in its
// order, the kernel's static shared memory last (19 values); WeightPlan's
// (6: o, o', i, i', shared memory, bulk). Refuses what the launches refuse.
int afcm_quantize_activations_plan(int n, int i, int ip, int h, int w, int p, int elem,
                                   long long x_address, int sms, long long* info) {
    if (n < 1 || i < 1 || ip < i || h < 1 || w < 1 || p < 0 || (elem != 2 && elem != 4) ||
        sms < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const ActPlan pl = plan_activations(n, i, ip, h, w, p, elem,
                                        static_cast<uintptr_t>(x_address), sms);
    cudaFuncAttributes attr{};
    const cudaError_t err = cudaFuncGetAttributes(&attr, quantize_activations_kernel<float, 4>);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long values[19] = {
        pl.n, pl.i, pl.ip, pl.h, pl.w, pl.p, pl.vec, pl.chunks, pl.groups, pl.halo,
        pl.halo_share, pl.count, pl.a_elems, pl.ta, pl.tq, pl.lag, pl.grid, pl.tickets,
        static_cast<long long>(attr.sharedSizeBytes)};
    for (int k = 0; k < 19; ++k) info[k] = values[k];
    return 0;
}

int afcm_quantize_weights_plan(int o, int op, int i, int ip, int elem, long long w_address,
                               int* info) {
    if (o < 1 || op < o || op % 64 != 0 || i < 1 || ip < i || ip % 32 != 0 ||
        (elem != 2 && elem != 4))
        return static_cast<int>(cudaErrorInvalidValue);
    const WPlan pl = plan_weights(o, op, i, ip, elem, static_cast<uintptr_t>(w_address));
    cudaFuncAttributes attr{};
    const cudaError_t err = cudaFuncGetAttributes(&attr, quantize_weights_kernel<float>);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int smem = pl.smem + static_cast<int>(attr.sharedSizeBytes);
    if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
    const int values[6] = {pl.o, pl.op, pl.i, pl.ip, smem, pl.bulk};
    for (int k = 0; k < 6; ++k) info[k] = values[k];
    return 0;
}

}  // extern "C"
