// Stream, copy and window-load probes for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU probe kernels of three scripts (no tap math in any):
//   scripts/probe_fir_roofline.py   build_copy :81, build_wr4x :94,
//                                   build_rd4x :112, build_chain :130
//   scripts/probe_stream_diag.py    copy3d :39, copy2d :49
//   scripts/probe_element_windows.py  the four pl.Element calls :41-104
// They exist to measure what hand-written loads and stores reach at the
// FIR layers' shapes, beside the fused filtered_lrelu kernel's time:
//   copy  : y = x, flat (build_copy), or a block of cb planes / br rows per
//           CTA (copy3d, copy2d)                    (read 1x, write 1x)
//   wr4x  : y[c][k] = x[c] * 2^-k, k = 0..3         (read 1x, write 4x)
//   rd4x  : y[c] = (x[c][0] + x[c][1]) + (x[c][2] + x[c][3])  (4x, 1x)
//   chain : x -> four scaled copies in shared memory -> leaky ReLU 0.2
//           -> pairwise sum -> y; device memory sees x in, y out
//   windows : out[ty][tx][c] = scale * (zero-padded x)[c, ty*sh - lo_h + (0..win_h),
//             tx*sw - lo_w + (0..win_w)]: overlapping, unaligned,
//             zero-filled input windows, channels zero-padded to c_out
// bf16 in and out for all but `windows` (fp32). Every product and sum is
// rounded to bf16 as the TPU kernels round them, with the card's own bf16x2
// operations (one rounding each, the same result as a float operation on
// two bf16 values rounded once: 24 >= 2 * 8 + 2 bits); a scale by a power of
// two is exact, and no product is contracted with a sum into an FMA. The
// results equal the plain versions bit for bit.
//
// What bounds them: bytes. The copies (copy_kernel, behind build_copy,
// copy3d and copy2d) keep nothing of the TPU kernels' rows: a span is
// copied as bytes, 2-byte accesses for the head up to the first 16-byte
// boundary and for the tail under 16 bytes, and the 16-byte body in pieces
// through a ring of stages in dynamic shared memory that one thread drives
// with bulk asynchronous copies (cp.async.bulk, the TMA without a tensor
// map): device memory -> stage on an mbarrier, stage -> device memory in a
// bulk group, and a stage is loaded again once cp.async.bulk.wait_group.read
// says the store out of it has read it. No thread spends a register or an
// instruction on the body, and rows of 276 bf16 (552 bytes, every other one
// 8 bytes off a 16-byte boundary) cost what aligned ones cost. copy3d and
// copy2d keep the TPU grid's meaning, one CTA per block of cb planes or br
// rows, whose pieces it takes in order (a ring of 6 x 32 KB: five loads in
// flight and one CTA an SM, which beat three CTAs of 4 x 16 KB an SM). The
// flat copy is a persistent grid of one CTA an SM (4 x 16 KB) whose CTAs
// claim the span's pieces from a counter in turn: a fixed share per CTA
// lost to Tensor.copy_, since the copy then lasts as long as its slowest
// SM. x and y share their offset modulo 16 (the wrapper allocates y so).
// The other flat kernels use 16-byte loads and stores wherever the address
// allows: a plane of h * w bf16 is a multiple of 16 bytes at every layer
// size of the generator (276^2, 148^2, 84^2, 52^2, 256^2), and other plane
// sizes take 2-byte accesses; they are persistent: 8 CTAs of 256 threads
// per SM walk the items with a grid stride. `chain` gives each CTA a tile
// of `tile` 16-byte items of x, 4 * tile * 16 bytes of shared memory (512
// items, 32 KB by default, seven CTAs per SM; up to 3584 items fill the 227
// KB one CTA can have), and every thread reads back items another thread
// wrote, so the shared round trip is real. `windows` (windows_kernel) is
// bound by its output, 2x the input at K1's windows: x (40 MB at variant
// A) fits in L2, so its overlapping window rows are read with plain loads
// and zero fill, and the output goes out in 16-byte bulk stores. Each CTA
// takes one window position and a group of channels (a multiple of 4), an
// output span of group * win_h * win_w values that it assembles in shared
// memory, scaled, and stores with bulk_store, the bulk copy's store; only a
// head and a tail under 16 bytes take plain stores (c_out not a multiple of
// 4). The kernel it replaces gave each output row to one warp: rows of 39
// floats kept 39 of 64 lanes busy, every store was a 4-byte store at an
// unaligned address, and each row paid a 64-bit division chain; a TMA
// tensor map cannot describe x (rows of 278 fp32 are 1,112 bytes, not a
// multiple of 16).
//
// Interface: plain C, loaded with ctypes; launches on the caller's stream
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <stddef.h>
#include <stdint.h>

#include "wgmma_s8.cuh"     // mbarriers and bulk copies

#define AFCM_PS_THREADS 256
#define AFCM_PS_MAX_BLOCKS (132 * 8)
#define AFCM_PS_RING_MAX 8          // stages of the bulk copy's ring (barriers held)
#define AFCM_PS_SMEM_MAX 232448     // dynamic shared memory one CTA can have

namespace {

constexpr int THREADS = AFCM_PS_THREADS;

// Two bf16 in a word. The card's own bf16 multiply, add and maximum round
// once to nearest even; the _rn forms are never contracted into an FMA.
__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t w) {
    return *reinterpret_cast<const __nv_bfloat162*>(&w);
}
__device__ __forceinline__ uint32_t as_word(__nv_bfloat162 h) {
    return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t scale_w(uint32_t w, float f) {
    return as_word(__hmul2_rn(as_bf2(w), __float2bfloat162_rn(f)));
}
__device__ __forceinline__ uint32_t add_w(uint32_t a, uint32_t b) {
    return as_word(__hadd2_rn(as_bf2(a), as_bf2(b)));
}
// where(t > 0, t, 0.2 * t) with 0.2 rounded to bf16, as the bf16 kernel's
// constant is: for t > 0 the product is below t, for t < 0 above it, so the
// maximum of the two is the same selection (and -0 stays -0).
__device__ __forceinline__ uint32_t lrelu_w(uint32_t w) {
    const __nv_bfloat162 t = as_bf2(w);
    return as_word(__hmax2(t, __hmul2_rn(t, __float2bfloat162_rn(0.2f))));
}

// An item is eight bf16 (16 bytes) or, for sizes that do not allow it, one.
template <typename V> struct Ops;

template <> struct Ops<uint4> {
    static __device__ __forceinline__ uint4 scale(uint4 v, float f) {
        return make_uint4(scale_w(v.x, f), scale_w(v.y, f), scale_w(v.z, f), scale_w(v.w, f));
    }
    static __device__ __forceinline__ uint4 add(uint4 a, uint4 b) {
        return make_uint4(add_w(a.x, b.x), add_w(a.y, b.y), add_w(a.z, b.z), add_w(a.w, b.w));
    }
    static __device__ __forceinline__ uint4 lrelu(uint4 v) {
        return make_uint4(lrelu_w(v.x), lrelu_w(v.y), lrelu_w(v.z), lrelu_w(v.w));
    }
};

template <> struct Ops<unsigned short> {
    static __device__ __forceinline__ unsigned short scale(unsigned short v, float f) {
        return static_cast<unsigned short>(scale_w(v, f));
    }
    static __device__ __forceinline__ unsigned short add(unsigned short a, unsigned short b) {
        return static_cast<unsigned short>(add_w(a, b));
    }
    static __device__ __forceinline__ unsigned short lrelu(unsigned short v) {
        return static_cast<unsigned short>(lrelu_w(v));
    }
};

// x [c][pv], y [c][4][pv] in items.
template <typename V>
__global__ void __launch_bounds__(THREADS)
wr4x_kernel(const V* __restrict__ x, V* __restrict__ y, long long items, int pv) {
    const long long stride = static_cast<long long>(gridDim.x) * THREADS;
    for (long long i = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x; i < items;
         i += stride) {
        const long long c = i / pv;
        V* o = y + (i - c * pv) + 4 * c * pv;
        const V v = x[i];
        o[0] = v;
        o[pv] = Ops<V>::scale(v, 0.5f);
        o[2 * static_cast<long long>(pv)] = Ops<V>::scale(v, 0.25f);
        o[3 * static_cast<long long>(pv)] = Ops<V>::scale(v, 0.125f);
    }
}

// x [c][4][pv], y [c][pv] in items.
template <typename V>
__global__ void __launch_bounds__(THREADS)
rd4x_kernel(const V* __restrict__ x, V* __restrict__ y, long long items, int pv) {
    const long long stride = static_cast<long long>(gridDim.x) * THREADS;
    for (long long i = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x; i < items;
         i += stride) {
        const long long c = i / pv;
        const V* p = x + (i - c * pv) + 4 * c * pv;
        const V a = p[0], b = p[pv], d = p[2 * static_cast<long long>(pv)],
                e = p[3 * static_cast<long long>(pv)];
        y[i] = Ops<V>::add(Ops<V>::add(a, b), Ops<V>::add(d, e));
    }
}

// Elementwise over `items`; each CTA walks tiles of `tile` items with the
// four scaled copies [4][tile] in shared memory.
template <typename V>
__global__ void __launch_bounds__(THREADS)
chain_kernel(const V* __restrict__ x, V* __restrict__ y, long long items, int tile) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    V* tmp = reinterpret_cast<V*>(smem_raw);
    const long long tiles = (items + tile - 1) / tile;
    for (long long tl = blockIdx.x; tl < tiles; tl += gridDim.x) {
        const long long base = tl * tile;
        for (int j = threadIdx.x; j < tile; j += THREADS) {
            if (base + j < items) {
                const V v = x[base + j];
                tmp[j] = v;
                tmp[tile + j] = Ops<V>::scale(v, 0.5f);
                tmp[2 * tile + j] = Ops<V>::scale(v, 0.25f);
                tmp[3 * tile + j] = Ops<V>::scale(v, 0.125f);
            }
        }
        __syncthreads();
        for (int j = threadIdx.x; j < tile; j += THREADS) {
            const int r = tile - 1 - j;                 // an item another thread wrote
            if (base + r < items) {
                const V a = Ops<V>::lrelu(tmp[r]), b = Ops<V>::lrelu(tmp[tile + r]);
                const V d = Ops<V>::lrelu(tmp[2 * tile + r]), e = Ops<V>::lrelu(tmp[3 * tile + r]);
                y[base + r] = Ops<V>::add(Ops<V>::add(a, b), Ops<V>::add(d, e));
            }
        }
        __syncthreads();
    }
}

// y = x over the pieces of a span of `bytes` (a multiple of 16) between
// 16-byte aligned addresses, driven by one thread: next() gives the offset
// of the next piece of stage_bytes (the last may be shorter; negative: none
// left), and the piece goes device memory -> stage -> device memory, the
// stages taken in turn. A stage's barrier completes once a round, so the
// i-th piece waits for parity (i / stages) & 1. A stage is loaded again
// only after the store out of it has read it (wait_group.read 1 after the
// next store is issued): the load and the store of a stage are both in the
// async proxy, ordered by the barrier and by wait_group.read, so no proxy
// fence stands between them. The caller waits for the last stores.
template <typename Next>
__device__ void copy_pieces(const unsigned char* x, unsigned char* y, long long bytes,
                            unsigned char* ring, uint64_t* bars, int stages, int stage_bytes,
                            Next next) {
    long long at[AFCM_PS_RING_MAX];
    auto size = [&](long long off) {
        const long long left = bytes - off;
        return static_cast<uint32_t>(left < stage_bytes ? left : stage_bytes);
    };
    auto load = [&](int s, long long off) {
        at[s] = off;
        afcm::mbar_expect_tx(bars + s, size(off));
        afcm::bulk_load(ring + s * stage_bytes, x + off, size(off), bars + s);
    };
    int loaded = 0;
    bool more = true;
    for (int s = 0; s < stages && more; ++s) {
        const long long off = next();
        if (off < 0) more = false;
        else { load(s, off); ++loaded; }
    }
    for (long long i = 0; loaded > 0; ++i) {
        const int s = static_cast<int>(i % stages);
        afcm::mbar_wait(bars + s, static_cast<uint32_t>((i / stages) & 1));
        afcm::bulk_store(y + at[s], ring + s * stage_bytes, size(at[s]));
        afcm::bulk_commit();
        --loaded;
        if (i >= 1 && more) {               // refill the stage of piece i - 1
            const long long off = next();
            if (off < 0) more = false;
            else {
                afcm::bulk_wait_read<1>();
                load(static_cast<int>((i - 1) % stages), off);
                ++loaded;
            }
        }
    }
}

// y = x over `nbytes` of bf16. Without a counter, CTA b copies the block of
// bytes [b * block_bytes, (b + 1) * block_bytes), the last CTA what is
// left, its pieces in order. With one (two words, zero at launch;
// block_bytes == nbytes), the CTAs share the whole span and claim its
// pieces from the counter in turn, so an SM that runs ahead takes more of
// them, and the last CTA to finish zeroes the counter again. One warp a
// CTA: lanes 0-6 copy the span's head up to the first 16-byte boundary,
// lanes 8-14 its tail under 16 bytes (2-byte accesses; CTA 0 for a shared
// span), and lane 0 the body through the ring of `stages` x `stage_bytes`
// in dynamic shared memory. x and y share their offset modulo 16.
__global__ void __launch_bounds__(32)
copy_kernel(const unsigned char* __restrict__ x, unsigned char* __restrict__ y,
            long long nbytes, long long block_bytes, int stages, int stage_bytes,
            unsigned long long* counter) {
    extern __shared__ __align__(128) unsigned char ring[];
    __shared__ __align__(8) uint64_t bars[AFCM_PS_RING_MAX];
    const long long lo = counter ? 0 : static_cast<long long>(blockIdx.x) * block_bytes;
    const long long len = block_bytes < nbytes - lo ? block_bytes : nbytes - lo;
    const unsigned char* src = x + lo;
    unsigned char* dst = y + lo;
    long long head = (16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15;
    if (head > len) head = len;
    const long long body = (len - head) & ~15LL, tail = len - head - body;
    const int lane = threadIdx.x;
    if (!counter || blockIdx.x == 0) {
        if (2 * lane < head)
            reinterpret_cast<unsigned short*>(dst)[lane] =
                reinterpret_cast<const unsigned short*>(src)[lane];
        if (lane >= 8 && 2 * (lane - 8) < tail) {
            const long long at = head + body + 2 * (lane - 8);
            *reinterpret_cast<unsigned short*>(dst + at) =
                *reinterpret_cast<const unsigned short*>(src + at);
        }
    }
    if (lane != 0 || body == 0) return;
    for (int s = 0; s < stages; ++s) afcm::mbar_init(bars + s, 1);
    // the barriers, initialised in the generic proxy, are used by the
    // async proxy's complete_tx
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    afcm::fence_proxy_async();
    const long long pieces = (body + stage_bytes - 1) / stage_bytes;
    if (counter) {
        copy_pieces(src + head, dst + head, body, ring, bars, stages, stage_bytes, [&] {
            const long long p = static_cast<long long>(atomicAdd(counter, 1ULL));
            return p < pieces ? p * stage_bytes : -1LL;
        });
        // counter[1] counts the CTAs whose claims are over; the last one
        // zeroes both for the next launch on this stream
        __threadfence();
        if (atomicAdd(counter + 1, 1ULL) == gridDim.x - 1) {
            atomicExch(counter, 0ULL);
            atomicExch(counter + 1, 0ULL);
        }
    } else {
        long long k = 0;
        copy_pieces(src + head, dst + head, body, ring, bars, stages, stage_bytes, [&] {
            return k < pieces ? stage_bytes * k++ : -1LL;
        });
    }
    // the CTA (and its shared memory) lasts until every store has landed
    afcm::bulk_wait<0>();
}

// out [n_th][n_tw][c_out][win_h][win_w] fp32. One CTA per window position
// and group of `group` channels (a multiple of 4): its output is one
// contiguous span of group * win_h * win_w values. The body of the span
// (from its first 16-byte boundary to its last) goes in chunks of `chunk`
// values (a multiple of 4) through shared memory: the threads load the
// windows' values with zero fill (plain loads from x, which L2 holds at the
// probe's sizes), scale them and write them in the span's order, and one
// thread stores the chunk with a bulk asynchronous copy (bulk_store). The
// head and tail of the span, under 16 bytes each (c_out not a multiple of
// 4), take plain stores. A thread walks its values of a chunk with counters
// (channel, row, column) advanced by THREADS values at a time: no division
// per value.
__global__ void __launch_bounds__(THREADS)
windows_kernel(const float* __restrict__ x, float* __restrict__ out, int C, int H, int W,
               int c_out, int win_h, int win_w, int n_tw, int groups, int group, int chunk,
               int sh, int sw, int lo_h, int lo_w, float scale) {
    extern __shared__ __align__(128) unsigned char win_smem[];
    float* buf = reinterpret_cast<float*>(win_smem);
    const int tid = threadIdx.x;
    const int area = win_h * win_w;
    const int tile = blockIdx.x / groups, cg = blockIdx.x - tile * groups;
    const int ty = tile / n_tw, tx = tile - ty * n_tw;
    const int c0 = cg * group, c1 = c0 + group < c_out ? c0 + group : c_out;
    const int y0 = ty * sh - lo_h, x0 = tx * sw - lo_w;
    const long long base = (static_cast<long long>(tile) * c_out + c0) * area;
    const long long len = static_cast<long long>(c1 - c0) * area;
    float* dst = out + base;

    // scale * xpad at (channel c0 + cl, window row r, column q)
    auto value = [&](int cl, int r, int q) {
        const int c = c0 + cl, gy = y0 + r, gx = x0 + q;
        float v = 0.f;
        if (c < C && gy >= 0 && gy < H && gx >= 0 && gx < W)
            v = x[(static_cast<size_t>(c) * H + gy) * W + gx];
        return scale * v;
    };
    auto value_at = [&](long long e) {          // e: a value's place in the span
        const int cl = static_cast<int>(e / area);
        const int rem = static_cast<int>(e - static_cast<long long>(cl) * area);
        return value(cl, rem / win_w, rem % win_w);
    };

    long long head = (4 - (base & 3)) & 3;      // out is 16-byte aligned
    if (head > len) head = len;
    const long long body = (len - head) & ~3LL, tail = len - head - body;
    if (tid < head) dst[tid] = value_at(tid);
    if (tid >= 32 && tid - 32 < tail) {
        const long long e = head + body + (tid - 32);
        dst[e] = value_at(e);
    }

    const int dq = THREADS % win_w, dr = (THREADS / win_w) % win_h, dc = THREADS / area;
    for (long long at = head; at < head + body; at += chunk) {
        const int n = static_cast<int>(head + body - at < chunk ? head + body - at : chunk);
        const long long e = at + tid;
        int cl = static_cast<int>(e / area);
        int rem = static_cast<int>(e - cl * static_cast<long long>(area));
        int r = rem / win_w, q = rem - r * win_w;
#pragma unroll 4
        for (int k = tid; k < n; k += THREADS) {
            buf[k] = value(cl, r, q);
            q += dq;
            const int cq = q >= win_w;
            q -= cq ? win_w : 0;
            r += dr + cq;
            const int cr = r >= win_h;
            r -= cr ? win_h : 0;
            cl += dc + cr;
        }
        afcm::fence_proxy_async();              // visible to the bulk copy
        __syncthreads();
        if (tid == 0) {
            afcm::bulk_store(dst + at, buf, static_cast<uint32_t>(n) * 4u);
            afcm::bulk_commit();
            afcm::bulk_wait_read<0>();          // buf is free
        }
        __syncthreads();
    }
}

int blocks_for(long long items) {
    const long long want = (items + THREADS - 1) / THREADS;
    return static_cast<int>(want < AFCM_PS_MAX_BLOCKS ? (want < 1 ? 1 : want) : AFCM_PS_MAX_BLOCKS);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// y = x, `nbytes` bytes of bf16, through rings of `stages` x `stage_bytes`
// of shared memory: with counter NULL one CTA per `block_bytes` (the last
// takes what is left; ctas must be their number), else `ctas` CTAs share
// the span (block_bytes == nbytes) and claim its pieces from counter[0]
// (two words, zero at launch, zero again after it; one counter per stream). x and y must share their offset modulo 16.
int afcm_probe_copy(const void* x, void* y, long long nbytes, long long block_bytes,
                    int ctas, int stages, int stage_bytes, void* counter, void* stream) {
    if (nbytes < 2 || nbytes % 2 || block_bytes < 2 || block_bytes % 2 || ctas < 1 ||
        stages < 2 || stages > AFCM_PS_RING_MAX || stage_bytes < 16 || stage_bytes % 16 ||
        static_cast<long long>(stages) * stage_bytes > AFCM_PS_SMEM_MAX ||
        (reinterpret_cast<uintptr_t>(x) & 15) != (reinterpret_cast<uintptr_t>(y) & 15) ||
        (counter ? block_bytes != nbytes
                 : (nbytes + block_bytes - 1) / block_bytes != ctas))
        return static_cast<int>(cudaErrorInvalidValue);
    const int smem = stages * stage_bytes;
    const cudaError_t err = cudaFuncSetAttribute(
        copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    copy_kernel<<<ctas, 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned char*>(x), static_cast<unsigned char*>(y), nbytes,
        block_bytes, stages, stage_bytes, static_cast<unsigned long long*>(counter));
    return static_cast<int>(cudaGetLastError());
}

// which: 0 = wr4x (x [c][plane] -> y [c][4][plane]), 1 = rd4x (x [c][4][plane]
// -> y [c][plane]); bf16.
int afcm_probe_x4(const void* x, void* y, long long c, int plane, int which, void* stream) {
    if (c < 1 || plane < 1 || which < 0 || which > 1)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool vec = plane % 8 == 0 && aligned16(x) && aligned16(y);
    const int pv = vec ? plane / 8 : plane;
    const long long items = c * pv;
    const int blocks = blocks_for(items);
    if (vec) {
        const uint4* xv = static_cast<const uint4*>(x);
        uint4* yv = static_cast<uint4*>(y);
        if (which == 0) wr4x_kernel<uint4><<<blocks, THREADS, 0, st>>>(xv, yv, items, pv);
        else rd4x_kernel<uint4><<<blocks, THREADS, 0, st>>>(xv, yv, items, pv);
    } else {
        const unsigned short* xs = static_cast<const unsigned short*>(x);
        unsigned short* ys = static_cast<unsigned short*>(y);
        if (which == 0) wr4x_kernel<unsigned short><<<blocks, THREADS, 0, st>>>(xs, ys, items, pv);
        else rd4x_kernel<unsigned short><<<blocks, THREADS, 0, st>>>(xs, ys, items, pv);
    }
    return static_cast<int>(cudaGetLastError());
}

// y = chain(x), `elems` bf16; `tile` items (16 bytes, or 2 where elems % 8)
// of x per CTA step, a multiple of 256; shared memory 4 * tile items.
int afcm_probe_chain(const void* x, void* y, long long elems, int tile, void* stream) {
    if (elems < 1 || tile < THREADS || tile % THREADS)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool vec = elems % 8 == 0 && aligned16(x) && aligned16(y);
    const long long items = vec ? elems / 8 : elems;
    const size_t smem = static_cast<size_t>(4) * tile * (vec ? 16 : 2);
    if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
    const long long tiles = (items + tile - 1) / tile;
    const int blocks = static_cast<int>(tiles < AFCM_PS_MAX_BLOCKS ? tiles : AFCM_PS_MAX_BLOCKS);
    cudaError_t err = vec
        ? cudaFuncSetAttribute(chain_kernel<uint4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem))
        : cudaFuncSetAttribute(chain_kernel<unsigned short>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (vec)
        chain_kernel<uint4><<<blocks, THREADS, smem, st>>>(
            static_cast<const uint4*>(x), static_cast<uint4*>(y), items, tile);
    else
        chain_kernel<unsigned short><<<blocks, THREADS, smem, st>>>(
            static_cast<const unsigned short*>(x), static_cast<unsigned short*>(y), items, tile);
    return static_cast<int>(cudaGetLastError());
}

// out fp32 [n_th][n_tw][c_out][win_h][win_w] of x fp32 [c][h][w], 16-byte
// aligned; one CTA per window position and `group` channels (a multiple of
// 4), chunks of `chunk` values (a multiple of 4) through shared memory.
int afcm_probe_windows(const void* x, void* out, int c, int h, int w, int c_out, int win_h,
                       int win_w, int n_th, int n_tw, int sh, int sw, int lo_h, int lo_w,
                       float scale, int group, int chunk, void* stream) {
    if (c < 1 || h < 1 || w < 1 || c_out < c || win_h < 1 || win_w < 1 || n_th < 1 || n_tw < 1 ||
        group < 4 || group % 4 || chunk < 4 || chunk % 4 ||
        static_cast<long long>(chunk) * 4 > AFCM_PS_SMEM_MAX || !aligned16(out) ||
        static_cast<long long>(win_h) * win_w > (1LL << 30))
        return static_cast<int>(cudaErrorInvalidValue);
    const int groups = (c_out + group - 1) / group;
    const long long ctas = static_cast<long long>(n_th) * n_tw * groups;
    if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const int smem = chunk * 4;
    const cudaError_t err = cudaFuncSetAttribute(
        windows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    windows_kernel<<<static_cast<unsigned>(ctas), THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<float*>(out), c, h, w, c_out, win_h, win_w,
        n_tw, groups, group, chunk, sh, sw, lo_h, lo_w, scale);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
