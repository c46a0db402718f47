// int8 matrix-rate probes for NVIDIA Hopper (sm_90a).
//
// Replaces two TPU probe kernels:
//   scripts/bench_int8_matmul.py: pallas_stacked -> stacked_mm_kernel (:30-52)
//       o[s] = a @ b[s]                      a [O,I], b [S,I,L] int8 -> int32
//   scripts/diag_int8_kernel.py: make -> kernel (:38-78), four modes
//       o[s] = bf16( sum_tap w[tap] @ x[s][:, off_tap : off_tap + N] )
//       with one tap, nine taps at offset 0, nine taps at off = dy * wp + dx,
//       and `sliceonly`: the nine shifted slices summed without a product.
// The first three modes and K8 are one function here (taps_matmul_kernel):
// for every s,
//       out[s] = sum_{tap < taps} w[tap] @ x[s][:, off[tap] : off[tap] + N]
// with int32 accumulation, written as int32 or rounded to bf16. `sliceonly`
// is slice_sum_kernel, whose note is above it. Integer sums have no
// rounding, so each result equals its plain version bit for bit.
//
// What bounds the products: K9 (nine taps, bf16 out) operations, K8 (one
// tap, int32 out) the bytes of its output. taps_matmul_kernel keeps the
// tensor cores fed and the output stores in the background:
//
// * The product is wgmma.mma_async m64n256k32 s8 x s8 -> s32 with both
//   operands in shared memory (wgmma_s8.cuh). A CTA computes 128 x 256
//   tiles of out[s]: two consumer warpgroups each keep 64 x 256 sums in
//   registers over a tile's whole K loop. A step is 1, 2 or 4 slices of
//   one product's K (32 bytes of I) for a group of taps.
// * One loader thread brings every step's operands by tensor-map copies
//   (TMA) and runs ahead of the products as far as the ring lets it: the
//   weights of all the step's taps as one box of [tap][128 rows][32 B] in
//   the 32-byte swizzle (w is K-major already), and x.
// * x as the TPU scripts have it, [S][I][P] with n contiguous, is the
//   transposed operand. Its bytes come raw once per step: 32 k rows of the
//   span of columns that every tap of the step reads (the tile's 256
//   columns plus the taps' spread: 256 + 322 at K9's offsets, three boxes
//   of 208 bytes a row). Three warps transpose that span once in shared
//   memory with byte permutes (prmt) into [K half][n row][16 B]. A tap is
//   then the same span read from a start address `off` rows (off * 16
//   bytes) further on, always a valid descriptor address (conv_int8.cu's
//   trick). The loop runs K steps outside and taps inside, so x is read
//   from memory and transposed once per K step for all taps, where the
//   mma.sync kernel it replaces loaded and transposed it again for each of
//   the nine taps. x as [S][P][I] (`kli`, K-major) comes by boxes straight
//   into that layout (rows of 32 bytes in the 32-byte swizzle where every
//   offset is a multiple of 8 rows, as K8's 0). Raw x whose rows cannot
//   take a tensor map (P not a multiple of 16, x off 16 bytes, a span
//   starting off 16 bytes) comes by cp.async, which the transposing warps
//   issue themselves.
// * A ring of stages on mbarriers (full: the weights' copy landed and the
//   span transposed; empty: the products are done) and a ring of raw
//   buffers (landed, transposed). The host plan (make_plan, mirrored by
//   ops/cuda/probe_int8.py:plan_taps) takes the most stages that fit the
//   227 KB one CTA can have, and a step covers 4, 2 or 1 slices of 32
//   bytes of K, as many as keep a ring of three: K9 one slice, 3 stages of
//   54 KB (+ 20 KB raw); K8 two slices, 4 stages of 24 KB (+ 16 KB raw)
//   beside its staged tile; K9's one tap four slices, 3 stages and 2 raw
//   buffers. Few products a step leave each step's handoffs exposed, so
//   the one-tap modes gain most from wider steps. One CTA an SM (128 sums
//   a consumer thread),
//   persistent: it walks tiles n-fastest and its ring runs on from one tile
//   into the next.
// * The epilogue writes an int32 tile (K8) into a staging region of its
//   own, one consumer warpgroup after the other, and one thread of each
//   stores its rows with bulk asynchronous copies (cp.async.bulk) while
//   the ring goes on loading the next tile; a bf16 tile (K9) goes out from
//   the registers, 16 bytes a lane quad. A tile past N (N a multiple of
//   128, not of 256) stores only its columns below N.
//
// Interface: plain C, loaded with ctypes; launches on the caller's stream
// and returns cudaGetLastError().

#include <cuda.h>             // CUtensorMap; its encoder comes from the driver at run time
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cudaTypedefs.h>     // PFN_cuTensorMapEncodeTiled

#include <stddef.h>
#include <stdint.h>

#include "wgmma_s8.cuh"

#define AFCM_P8_BM 128         // rows of out per CTA: two warpgroups of 64
#define AFCM_P8_BN 256         // columns of out per CTA: one product's N
#define AFCM_P8_KC 32          // a K slice: one product's K
#define AFCM_P8_THREADS 384    // loader and transposers, two consumer warpgroups
#define AFCM_P8_MAX_TAPS 9
#define AFCM_P8_MAX_STAGES 8
#define AFCM_P8_BOX_MAX 256    // bytes (raw x) or rows (K-major x) of a tensor-map box
// dynamic shared memory of one CTA: 227 KB less the static barriers, of
// which 1 KB aligns the ring
#define AFCM_P8_SMEM_BUDGET (232448 - 4 * 8 * AFCM_P8_MAX_STAGES)

namespace {

constexpr int BM = AFCM_P8_BM;
constexpr int BN = AFCM_P8_BN;
constexpr int KC = AFCM_P8_KC;
constexpr int THREADS = AFCM_P8_THREADS;
constexpr int WG = 128;                        // threads of a warpgroup
constexpr int TRANSPOSERS = 96;                // warps 1-3
constexpr int A_TAP_BYTES = BM * KC;           // one tap's weights of a step: [128 rows][32 B]
constexpr int ALIGN = 1024;                    // the ring's start in shared memory

using afcm::bulk_commit;
using afcm::bulk_load;
using afcm::bulk_store;
using afcm::bulk_wait;
using afcm::bulk_wait_read;
using afcm::cp_async16_zfill;
using afcm::cp_async8_zfill;
using afcm::cp_async_commit;
using afcm::cp_async_wait;
using afcm::mbar_arrive;
using afcm::mbar_expect_tx;
using afcm::mbar_init;
using afcm::mbar_wait;

// How a call is staged (make_plan). Taps are taken in groups, each group's
// taps in one step: group g holds taps [first[g], first[g + 1]) of tap[]
// (indices into w, in order of offset); its span starts at column (row for
// K-major x) base[g] of the tile and a tap is read off[] rows into it.
struct Plan {
    int groups;
    int first[AFCM_P8_MAX_TAPS + 1];
    int tap[AFCM_P8_MAX_TAPS];
    int off[AFCM_P8_MAX_TAPS];
    int base[AFCM_P8_MAX_TAPS];
    int span;          // staged rows of x a step (multiple of 8)
    int ksub;          // K slices of 32 bytes a step
    int a_bytes;       // weights of a slice: A_TAP_BYTES per tap of a group
    int slice_bytes;   // a slice of a stage: a_bytes + 32 * span
    int stage_bytes;   // ksub * slice_bytes
    int xboxes, xw;    // x's tensor-map boxes a step: raw, of 32 ksub rows of xw bytes
                       // (by cp.async: 1 box, xw = its rows' bytes); K-major, per
                       // slice and half, of xw rows of 16 bytes
    int x_tma;         // raw x by tensor map (else by cp.async)
    int b_sw32;        // K-major x as [span][32 B] in the 32-byte swizzle (every offset a
                       // multiple of 8 rows), else as [half][span][16 B]
    int stages;        // the ring's stages
    int raws;          // raw x's buffers (2 .. stages; 0 for K-major x)
    int epi_bytes;     // int32 out: the staged tile of one consumer warpgroup at a
                       // time, 64 rows of 4 BN + 16 bytes
    int smem;
};

int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Tap groups, span and ring for `taps` offsets and i bytes of K: every tap
// in one group if a ring of two stages or more fits, else one group per
// tap. A step takes 4, 2 or 1 K slices of 32 bytes (i allowing), the most
// with which a ring of three stages fits (one slice: two), and the ring the
// most stages (at most 8) that fit beside the staged int32 tile with as
// many raw buffers, else with two. Raw x
// comes by tensor-map boxes of up to 256 bytes a row where tma_ok and every
// group's span starts on 16 bytes, else by cp.async rows from the span's
// start rounded down to 8 or 16 bytes (32 bytes of slack); K-major x comes
// by boxes of up to 256 rows, the span rounded to fill them: rows of 32
// bytes in the 32-byte swizzle where every tap's offset is a multiple of 8
// rows (an 8-row atom), else one box per 16-byte half.
bool make_plan(const int* offs, int taps, int i, bool raw, bool tma_ok, int out_bytes,
               Plan& pl) {
    int order[AFCM_P8_MAX_TAPS];
    for (int t = 0; t < taps; ++t) {            // stable insertion sort by offset
        int j = t;
        while (j > 0 && offs[order[j - 1]] > offs[t]) {
            order[j] = order[j - 1];
            --j;
        }
        order[j] = t;
    }
    for (int per_tap = 0; per_tap < 2; ++per_tap) {
        for (int ksub = 4; ksub >= 1; ksub /= 2) {
            if (i % (KC * ksub)) continue;
            pl = Plan{};
            pl.groups = per_tap ? taps : 1;
            pl.ksub = ksub;
            int spread = 0, most = 0;
            bool aligned16 = true;
            for (int g = 0; g < pl.groups; ++g) {
                pl.first[g] = per_tap ? g : 0;
                pl.first[g + 1] = per_tap ? g + 1 : taps;
                pl.base[g] = offs[order[pl.first[g]]];
                aligned16 = aligned16 && pl.base[g] % 16 == 0;
                for (int j = pl.first[g]; j < pl.first[g + 1]; ++j) {
                    pl.tap[j] = order[j];
                    pl.off[j] = offs[order[j]] - pl.base[g];
                    spread = pl.off[j] > spread ? pl.off[j] : spread;
                }
                const int count = pl.first[g + 1] - pl.first[g];
                most = count > most ? count : most;
            }
            pl.span = round_up(BN + spread, 8);
            if (raw && tma_ok && aligned16) {
                pl.x_tma = 1;
                pl.xboxes = (pl.span + AFCM_P8_BOX_MAX - 1) / AFCM_P8_BOX_MAX;
                pl.xw = round_up((pl.span + pl.xboxes - 1) / pl.xboxes, 16);
            } else if (raw) {
                pl.xboxes = 1;
                pl.xw = round_up(pl.span + 32, 16);
            } else {
                pl.xboxes = (pl.span + AFCM_P8_BOX_MAX - 1) / AFCM_P8_BOX_MAX;
                pl.xw = round_up((pl.span + pl.xboxes - 1) / pl.xboxes, 8);
                pl.span = pl.xboxes * pl.xw;
                pl.b_sw32 = 1;
                for (int j = 0; j < taps; ++j) pl.b_sw32 = pl.b_sw32 && pl.off[j] % 8 == 0;
            }
            pl.a_bytes = A_TAP_BYTES * most;
            pl.slice_bytes = pl.a_bytes + 2 * 16 * pl.span;
            pl.stage_bytes = ksub * pl.slice_bytes;
            pl.epi_bytes = out_bytes == 4 ? 64 * (BN * out_bytes + 16) : 0;
            const long long raw_bytes =
                raw ? static_cast<long long>(pl.xboxes) * KC * ksub * pl.xw : 0;
            for (int two = 0; two < (raw ? 2 : 1); ++two) {
                for (int stages = AFCM_P8_MAX_STAGES; stages >= (ksub > 1 ? 3 : 2); --stages) {
                    const int raws = raw ? (two ? 2 : stages) : 0;
                    const long long smem = stages * pl.stage_bytes + raws * raw_bytes +
                                           pl.epi_bytes + ALIGN;
                    if (smem <= AFCM_P8_SMEM_BUDGET) {
                        pl.stages = stages;
                        pl.raws = raws;
                        pl.smem = static_cast<int>(smem);
                        return true;
                    }
                }
            }
        }
    }
    return false;
}

__device__ __forceinline__ void bar_sync(int id, int count) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Named barriers (0 is __syncthreads).
constexpr int BAR_PRODUCER = 1;     // the transposers' 96 threads (raw x by cp.async)
constexpr int BAR_WG = 2;           // + c: consumer warpgroup c's staged tile
constexpr int BAR_TURN = 4;         // warpgroup 0 -> 1: the staging region is free
constexpr int BAR_BACK = 5;         // warpgroup 1 -> 0: the staging region is free

// Wait until at most `pending` (0..6) committed cp.async groups are in flight.
__device__ __forceinline__ void cp_async_wait_upto(int pending) {
    switch (pending) {
        case 0: cp_async_wait<0>(); break;
        case 1: cp_async_wait<1>(); break;
        case 2: cp_async_wait<2>(); break;
        case 3: cp_async_wait<3>(); break;
        case 4: cp_async_wait<4>(); break;
        case 5: cp_async_wait<5>(); break;
        default: cp_async_wait<6>(); break;
    }
}

// A box of a 3-D tensor map at (c0, c1, c2) into shared memory, completion
// reported to `bar`.
__device__ __forceinline__ void tma_load_3d(void* smem, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(afcm::smem_addr(smem)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
        "r"(afcm::smem_addr(bar))
        : "memory");
}

// Descriptor of a K-major operand in the 32-byte swizzle (the tensor map's
// CU_TENSOR_MAP_SWIZZLE_32B): rows of 32 bytes, 8-row atoms 256 bytes apart.
__device__ __forceinline__ uint64_t wgmma_desc_sw32(const void* smem) {
    return afcm::wgmma_desc(smem, 16, 256) | (3ull << 62);
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// int32 -> float -> bf16, both round to nearest even, as
// acc.to(float32).to(bfloat16) rounds.
__device__ __forceinline__ __nv_bfloat16 to_bf16(int v) {
    return __float2bfloat16_rn(__int2float_rn(v));
}

__device__ __forceinline__ void store_pair(int* p, int v0, int v1) {
    *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, int v0, int v1) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(to_bf16(v0), to_bf16(v1));
}

// The tiles of one CTA and the steps of each, in order: CTA b takes tiles
// b, b + gridDim.x, ... of the n_tiles x (O / 128) x S tiles, n fastest.
struct Walk {
    int n_tiles, m_tiles, tiles, per_tile;
    int tile, j, G;                             // current tile, its step, the CTA's step
    __device__ Walk(int n_tiles_, int m_tiles_, int tiles_, int per_tile_)
        : n_tiles(n_tiles_), m_tiles(m_tiles_), tiles(tiles_), per_tile(per_tile_),
          tile(blockIdx.x), j(0), G(0) {}
    __device__ bool more() const { return tile < tiles; }
    __device__ int n0() const { return tile % n_tiles * BN; }
    __device__ int m0() const { return tile / n_tiles % m_tiles * BM; }
    __device__ int s() const { return tile / n_tiles / m_tiles; }
    __device__ void next() {
        ++G;
        if (++j == per_tile) {
            j = 0;
            tile += gridDim.x;
        }
    }
};

// out[s][O][N] = sum_tap w[tap][O][I] @ X_s, with
//   RAW:  x [S][I][P], X_s = x[s][:, off : off + N]   (n contiguous)
//   !RAW: x [S][P][I], X_s = x[s][off : off + N, :]^T  (k contiguous)
// w comes through wmap (3-D {I, O, taps}, boxes of 32 x 128 x group taps,
// 32-byte swizzle), x through xmap (raw: 3-D {P, I, S}, boxes of xw x 32;
// K-major: 3-D {I, P, S}, boxes of 16 x xw) unless raw x comes by cp.async
// pieces of `piece` bytes. Persistent: each CTA walks its tiles (Walk) and
// its ring runs on from one tile's steps to the next's.
//
// Roles: warp 0 (its lane 0) loads, ahead of everyone as far as the ring
// lets it: a stage's weights (and K-major x) once the stage's products are
// done, raw x once its buffer is transposed. Warps 1-3 transpose raw x into
// the stages. Warps 4-11 are the two consumer warpgroups.
template <typename OutT, bool RAW>
__global__ void __launch_bounds__(THREADS, 1)
taps_matmul_kernel(const int8_t* __restrict__ x, OutT* __restrict__ out, int O, int I, int P,
                   int N, int n_tiles, int tiles, int piece,
                   const __grid_constant__ CUtensorMap wmap,
                   const __grid_constant__ CUtensorMap xmap, const __grid_constant__ Plan pl) {
    // int32 tiles go out by bulk stores from shared memory, bf16 ones
    // straight from the registers
    constexpr bool STAGED = sizeof(OutT) == 4;
    extern __shared__ unsigned char smem_raw[];
    __shared__ __align__(8) uint64_t full[AFCM_P8_MAX_STAGES];     // a stage is loaded
    __shared__ __align__(8) uint64_t empty[AFCM_P8_MAX_STAGES];    // a stage is multiplied
    __shared__ __align__(8) uint64_t landed[AFCM_P8_MAX_STAGES];   // a raw buffer is loaded
    __shared__ __align__(8) uint64_t rawfree[AFCM_P8_MAX_STAGES];  // ... and transposed

    const int tid = threadIdx.x;
    // warp-uniform for the compiler too, so that the products are not
    // serialized as in a divergent path
    const int wg = __shfl_sync(0xffffffffu, tid / WG, 0), t = tid % WG;
    const int warp = t / 32, lane = t % 32;
    const int KS = KC * pl.ksub;                // K bytes a step
    const int per_tile = (I / KS) * pl.groups;  // k step outside, tap group inside
    const int S = pl.stages, R = pl.raws;
    unsigned char* smem = smem_raw + ((ALIGN - afcm::smem_addr(smem_raw) % ALIGN) % ALIGN);
    unsigned char* raw_ring = smem + S * pl.stage_bytes;
    const int raw_bytes = RAW ? pl.xboxes * KS * pl.xw : 0;
    const bool x_tma = !RAW || pl.x_tma;

    if (tid == 0) {
        for (int i = 0; i < S; ++i) {
            mbar_init(&full[i], RAW ? 3 + 1 : 1);   // transposer warps + the loader's copies
            mbar_init(&empty[i], 8);                 // consumer warps
            mbar_init(&landed[i], 1);
            mbar_init(&rawfree[i], 3);               // transposer warps
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (wg == 0 && warp == 0) {
        // ------------------------------------------------------------- loader
        if (lane != 0) return;
        for (Walk at(n_tiles, O / BM, tiles, per_tile); at.more(); at.next()) {
            const int G = at.G, slot = G % S, pass = G / S;
            const int g = at.j % pl.groups, k0 = at.j / pl.groups * KS;
            const int col0 = at.n0() + pl.base[g];
            if (RAW && x_tma) {                  // raw x, once step G - R is transposed
                const int rs = G % R;
                if (G >= R) mbar_wait(&rawfree[rs], (G / R + 1) & 1);
                unsigned char* rw = raw_ring + rs * raw_bytes;
                mbar_expect_tx(&landed[rs], raw_bytes);
                for (int b = 0; b < pl.xboxes; ++b)
                    tma_load_3d(rw + b * KS * pl.xw, &xmap, col0 + b * pl.xw, k0, at.s(),
                                &landed[rs]);
            }
            if (G >= S) mbar_wait(&empty[slot], (pass + 1) & 1);   // step G - S multiplied
            const int count = pl.first[g + 1] - pl.first[g];
            const int tap0 = pl.groups == 1 ? 0 : pl.tap[pl.first[g]];
            mbar_expect_tx(&full[slot],
                           pl.ksub * (count * A_TAP_BYTES + (RAW ? 0 : 32 * pl.span)));
            for (int ks = 0; ks < pl.ksub; ++ks) {
                unsigned char* sl = smem + slot * pl.stage_bytes + ks * pl.slice_bytes;
                tma_load_3d(sl, &wmap, k0 + ks * KC, at.m0(), tap0, &full[slot]);
                if (!RAW)                        // K-major x: [span][32 B] or [half][span][16 B]
                    for (int half = 0; half < 2 - pl.b_sw32; ++half)
                        for (int b = 0; b < pl.xboxes; ++b)
                            tma_load_3d(sl + pl.a_bytes + (half * pl.span + b * pl.xw) *
                                                              (16 << pl.b_sw32),
                                        &xmap, k0 + ks * KC + 16 * half, col0 + b * pl.xw,
                                        at.s(), &full[slot]);
            }
        }
        return;
    }

    if (wg == 0) {
        // --------------------------------------------------------- transposers
        if (!RAW) return;
        const int tt = t - 32;                   // 0 .. TRANSPOSERS - 1
        // cp.async loads of raw x for step G (every transposer thread): 32 k
        // rows from the span's start rounded down to a piece.
        auto issue_async = [&](const Walk& at) {
            const int g = at.j % pl.groups, k0 = at.j / pl.groups * KS;
            const int8_t* xs = x + static_cast<size_t>(at.s()) * I * P;
            const int c0 = (at.n0() + pl.base[g]) & ~(piece - 1);
            const int per_row = pl.xw / piece;
            unsigned char* rw = raw_ring + at.G % R * raw_bytes;
            for (int k = warp - 1; k < KS; k += 3) {
                const int8_t* row = xs + static_cast<size_t>(k0 + k) * P;
                for (int q = lane; q < per_row; q += 32) {
                    const int col = c0 + q * piece;
                    const bool in = col < P;            // a piece is all in or all out
                    unsigned char* dst = rw + k * pl.xw + q * piece;
                    if (piece == 16)
                        cp_async16_zfill(dst, in ? row + col : xs, in ? 16u : 0u);
                    else
                        cp_async8_zfill(dst, in ? row + col : xs, in ? 8u : 0u);
                }
            }
        };
        Walk ahead(n_tiles, O / BM, tiles, per_tile);   // cp.async: R - 1 steps ahead
        if (!x_tma) {
            for (int k = 0; k < R - 1; ++k) {
                if (ahead.more()) {
                    issue_async(ahead);
                    ahead.next();
                }
                cp_async_commit();
            }
        }
        for (Walk at(n_tiles, O / BM, tiles, per_tile); at.more(); at.next()) {
            const int G = at.G, slot = G % S, pass = G / S, rs = G % R;
            if (x_tma) {
                mbar_wait(&landed[rs], (G / R) & 1);
            } else {
                cp_async_wait_upto(R - 2);           // this thread's loads of step G
                bar_sync(BAR_PRODUCER, TRANSPOSERS); // ... everyone's; step G - 1's buffer free
            }
            if (G >= S) mbar_wait(&empty[slot], (pass + 1) & 1);   // the stage is free
            // raw buffer -> each slice's [half][span][16 B]: a thread takes 4
            // columns of one half of one slice, 16 words of 4 bytes (k rows),
            // and writes the 4 columns' 16-byte rows. Column c of the span is
            // byte c % xw of box c / xw's rows (tensor map), or byte c + sh
            // of the one box's rows (cp.async: sh is the span start's offset).
            const int g = at.j % pl.groups;
            const unsigned char* rw = raw_ring + rs * raw_bytes;
            const int sh = x_tma ? 0 : (at.n0() + pl.base[g]) & (piece - 1);
            const int quads = pl.span / 4;
            for (int u = tt; u < 2 * pl.ksub * quads; u += TRANSPOSERS) {
                const int rows = u / quads, c = 4 * (u - rows * quads);   // rows: 16 k rows
                const int ks = rows >> 1, half = rows & 1;
                unsigned char* bt = smem + slot * pl.stage_bytes + ks * pl.slice_bytes + pl.a_bytes;
                const int box = c / pl.xw;
                const unsigned char* src =
                    rw + (box * KS + 16 * rows) * pl.xw + (c - box * pl.xw) + sh;
                uint32_t v[16];
                if ((sh & 3) == 0) {
#pragma unroll
                    for (int r = 0; r < 16; ++r) v[r] = lds32(src + r * pl.xw);
                } else {
                    const unsigned char* al = src - (sh & 3);
#pragma unroll
                    for (int r = 0; r < 16; ++r)
                        v[r] = __funnelshift_r(lds32(al + r * pl.xw), lds32(al + r * pl.xw + 4),
                                               8 * (sh & 3));
                }
                uint32_t col[4][4];     // col[jc][m]: column c + jc, k rows 4m..4m+3
#pragma unroll
                for (int m = 0; m < 4; ++m) {
                    const uint32_t t0 = __byte_perm(v[4 * m], v[4 * m + 1], 0x5140);
                    const uint32_t t1 = __byte_perm(v[4 * m + 2], v[4 * m + 3], 0x5140);
                    const uint32_t t2 = __byte_perm(v[4 * m], v[4 * m + 1], 0x7362);
                    const uint32_t t3 = __byte_perm(v[4 * m + 2], v[4 * m + 3], 0x7362);
                    col[0][m] = __byte_perm(t0, t1, 0x5410);
                    col[1][m] = __byte_perm(t0, t1, 0x7632);
                    col[2][m] = __byte_perm(t2, t3, 0x5410);
                    col[3][m] = __byte_perm(t2, t3, 0x7632);
                }
#pragma unroll
                for (int jc = 0; jc < 4; ++jc)
                    *reinterpret_cast<uint4*>(bt + (half * pl.span + c + jc) * 16) =
                        make_uint4(col[jc][0], col[jc][1], col[jc][2], col[jc][3]);
            }
            afcm::fence_proxy_async();          // this thread's writes, visible to wgmma
            __syncwarp();
            if (lane == 0) {
                mbar_arrive(&full[slot]);
                if (x_tma) mbar_arrive(&rawfree[rs]);
            }
            if (!x_tma) {
                if (ahead.more()) {              // into step G - 1's buffer
                    issue_async(ahead);
                    ahead.next();
                }
                cp_async_commit();
            }
        }
        return;
    }

    // -------------------------------------------------------------- consumers
    const int c = wg - 1;                       // rows 64 c .. 64 c + 63 of a tile
    const int gq = lane >> 2, q = lane & 3;
    constexpr int PITCH = BN * static_cast<int>(sizeof(OutT)) + 16;
    unsigned char* staged = raw_ring + R * raw_bytes;     // one warpgroup's tile at a time
    int acc[BN / 2];
    for (Walk at(n_tiles, O / BM, tiles, per_tile); at.more();) {
        const int n0 = at.n0(), m0 = at.m0(), s = at.s();
#pragma unroll
        for (int r = 0; r < BN / 2; ++r) acc[r] = 0;
        do {
            const int G = at.G, g = at.j % pl.groups;
            mbar_wait(&full[G % S], (G / S) & 1);
            const unsigned char* st = smem + (G % S) * pl.stage_bytes;
            // A: [tap][128 rows][32 B] swizzled, this warpgroup's 64 rows 2
            // KB in; B: [half][span][16 B], halves span * 16 B apart, 8-row
            // groups 128 B apart (or [span][32 B] swizzled); one of each a
            // slice. A tap's offset moves B's start by whole rows.
            const uint64_t desc_a = wgmma_desc_sw32(st + c * 64 * KC);
            const uint64_t desc_b = pl.b_sw32
                                        ? wgmma_desc_sw32(st + pl.a_bytes)
                                        : afcm::wgmma_desc(st + pl.a_bytes, pl.span * 16, 128);
            const int row16 = 1 + pl.b_sw32;    // a row of B in 16-byte units
            afcm::wgmma_fence_operands(acc);
            afcm::wgmma_fence();
            for (int ks = 0; ks < pl.ksub; ++ks)
                for (int jt = pl.first[g]; jt < pl.first[g + 1]; ++jt)
                    afcm::wgmma_s8<BN>(
                        acc,
                        desc_a + ((pl.groups == 1 ? pl.tap[jt] : 0) * A_TAP_BYTES +
                                  ks * pl.slice_bytes) / 16,
                        desc_b + (ks * pl.slice_bytes) / 16 + row16 * pl.off[jt]);
            afcm::wgmma_commit();
            afcm::wgmma_wait<1>();              // step G - 1's products are done
            afcm::wgmma_fence_operands(acc);
            if (at.j > 0 && lane == 0) mbar_arrive(&empty[(G - 1) % S]);
            at.next();
        } while (at.j != 0);
        afcm::wgmma_wait<0>();
        afcm::wgmma_fence_operands(acc);
        if (lane == 0) mbar_arrive(&empty[(at.G - 1) % S]);

        if (STAGED) {
            // The tile into the staging region once the other warpgroup's
            // bulk stores have read it (warpgroup 0, then 1, tile by tile);
            // one thread stores its rows with bulk copies, which drain under
            // the next tile's work.
            if (c == 1) bar_sync(BAR_TURN, 2 * WG);
            else if (at.G > per_tile) bar_sync(BAR_BACK, 2 * WG);
#pragma unroll
            for (int j = 0; j < BN / 8; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    store_pair(reinterpret_cast<OutT*>(staged + (16 * warp + gq + 8 * h) * PITCH) +
                                   8 * j + 2 * q,
                               acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
            afcm::fence_proxy_async();          // visible to the bulk copies
            bar_sync(BAR_WG + c, WG);
            if (t == 0) {
                const int cols = N - n0 < BN ? N - n0 : BN;
                const uint32_t bytes = static_cast<uint32_t>(cols * sizeof(OutT));
                OutT* dst = out + (static_cast<size_t>(s) * O + m0 + 64 * c) * N + n0;
                for (int r = 0; r < 64; ++r)
                    bulk_store(dst + static_cast<size_t>(r) * N, staged + r * PITCH, bytes);
                bulk_commit();
                bulk_wait_read<0>();
            }
            // the region is the other warpgroup's (warpgroup 1 hands it back
            // unless this was the CTA's last tile)
            bar_sync(BAR_WG + c, WG);
            if (c == 0) bar_arrive(BAR_TURN, 2 * WG);
            else if (at.more()) bar_arrive(BAR_BACK, 2 * WG);
        } else {
            // a lane quad's 8 columns (16 bytes) of a row, both halves of the
            // fragment's rows
            OutT* dst = out + (static_cast<size_t>(s) * O + m0 + 64 * c + 16 * warp + gq) * N +
                        n0 + 2 * q;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
                if (n0 + 8 * j >= N) break;
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    store_pair(dst + static_cast<size_t>(8 * h) * N + 8 * j,
                               acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
            }
        }
    }
}

// ------------------------------------------------------------ slice sums
//
// `sliceonly` (scripts/diag_int8_kernel.py:38, mode="sliceonly"): for every
// step s,
//     out[s][o][n] = bf16( sum_tap int32(x[s][o][off_tap + n]) )   o < I,
// rows I <= o < O zero; no product. What bounds it: bytes, the bytes
// [min off, max off + N) of each x row read once and out written once (at
// the probe's shape 179.1 MB + 408.9 MB / 3.35 TB/s = 0.1755 ms). The
// kernel it replaces gave each thread eight columns and paid for every tap
// with two 8-byte loads of x through L1/L2 (x read 18 times over), a funnel
// shift and eight sign extensions and adds, on a grid of one CTA per 256
// items of a step: its integer work alone took as long as the bound, and
// its zero rows cost threads like live ones. slice_sum_kernel:
// * is persistent, `ctas` CTAs an SM (make_slice_plan). A CTA walks units
//   of (s, `rows` rows of o), units b, b + grid, ...; a unit's rows at or
//   past I read nothing: the loading thread stores them from a zeroed
//   region of shared memory with bulk copies;
// * stages a unit's live x rows, rows * P contiguous bytes, once for all
//   taps with one bulk copy (cp.async.bulk global -> shared, completing on
//   an mbarrier) through a ring of `stages`, so that the next units' rows
//   land while this one sums. A span that starts 8 bytes off 16 (P % 16 ==
//   8, or x a view 8 bytes off) takes its first and last 8 bytes by plain
//   loads of the loading thread and the 16-byte body by the bulk copy;
// * sums packed: a summing thread takes four neighbouring columns, two
//   of them a pass so that one's loads overlap the other's sums. Per tap,
//   one funnel shift of two aligned words read from shared memory gives the
//   four bytes at any offset; each byte is biased to unsigned (^ 0x80) and
//   split into the two 16-bit lanes of a word, even columns by one LOP3
//   ((v ^ 0x00800080) & 0x00ff00ff), odd ones by another and a
//   multiply-high by 2^24 that moves them down and adds them (on the
//   multiply-add pipe, beside the integer pipe). 9 * 255 fits a lane; the
//   bias, 128 a tap, comes off once at the end. Five instructions and two
//   loads a tap for four columns, where the old kernel spent some 25 for
//   eight; the kernel is templated on the tap count, so that the taps'
//   loads are straight-line code. Nine taps in three runs of three
//   neighbouring offsets (the probe's 3 x 3 grid, any row pitch) take one
//   load of three words, two funnel shifts and three more of the pair for
//   a run, whose four byte pairs (sh + m, sh + m + 2), m = 0..3, give the
//   even columns (m = 0, 1, 2) and the odd ones (m = 1, 2, 3): half the
//   loads and no multiply (3-6% off the general path's time at the probe's
//   shape on an H100, PERF.md section 6);
// * writes each unit's bf16 rows into a staging ring of two in shared
//   memory, and one thread stores them with one bulk copy (shared ->
//   global) of rows * N * 2 contiguous bytes; a staging buffer is written
//   again only once cp.async.bulk.wait_group.read says its store has read
//   it.
// Warp 0 (its lane 0) loads and stores the zero rows; warps 1-8 sum, and
// warp 1's lane 0 stores. Integer sums are exact and |sum| <= 9 * 127, so
// the one rounding is to_bf16's: the result equals the plain version bit
// for bit.

#define AFCM_SL_THREADS 288         // one loading warp, eight summing warps
#define AFCM_SL_SUMMERS 256
#define AFCM_SL_MAX_STAGES 4
#define AFCM_SL_ZERO 4096           // bytes of zeros the dead rows are stored from
#define AFCM_SL_SMEM_SM 233472      // shared memory of an SM (228 KB)
#define AFCM_SL_STATIC (2 * 8 * AFCM_SL_MAX_STAGES)   // the static barriers

// How slice_sum_kernel stages a call (make_slice_plan; mirrored by
// ops/cuda/probe_int8.py:plan_slice_sum).
struct SlicePlan {
    int rows;        // rows of o a unit
    int stages;      // x stages of the ring
    int ctas;        // CTAs an SM
    int in_bytes;    // an x stage: rows * P bytes and 32 of slack, rounded up to 128
    int out_bytes;   // a staging buffer of out: rows * N * 2 bytes (two of them)
    int smem;        // stages * in_bytes + 2 * out_bytes + the zeros + 128 to align
};

// The taps in order of offset: a tap reads the two words at byte
// word[j] (off & ~3) of a thread's four columns and shifts them right by
// shift[j] bits (8 * (off & 3)). Nine taps in three runs of three
// neighbouring offsets (a 3 x 3 grid, whatever its row pitch) are given as
// their runs' first offsets, in entries 0-2.
struct SliceTaps {
    int word[AFCM_P8_MAX_TAPS];
    int shift[AFCM_P8_MAX_TAPS];
};

// The most rows a unit (8, 4, 2, 1), then the most CTAs an SM (2, 1),
// then the most stages (3, 2) that fit the SM's shared memory, for rows of
// p bytes of x and n columns.
bool make_slice_plan(int p, int n, SlicePlan& pl) {
    for (int rows = 8; rows >= 1; rows /= 2)
        for (int ctas = 2; ctas >= 1; --ctas)
            for (int stages = 3; stages >= 2; --stages) {
                const long long in = (static_cast<long long>(rows) * p + 32 + 127) / 128 * 128;
                const long long out = static_cast<long long>(rows) * n * 2;
                const long long smem = stages * in + 2 * out + AFCM_SL_ZERO + 128;
                long long budget = AFCM_SL_SMEM_SM / ctas - 1024;   // 1 KB a CTA for the system
                if (budget > 232448) budget = 232448;
                if (smem + AFCM_SL_STATIC <= budget) {
                    pl = SlicePlan{rows, stages, ctas, static_cast<int>(in),
                                   static_cast<int>(out), static_cast<int>(smem)};
                    return true;
                }
            }
    return false;
}

constexpr int BAR_FREE = 1;      // summing warps: this unit's staging buffer is free
constexpr int BAR_WRITTEN = 2;   // summing warps -> warp 1: the unit's rows are staged

// The lane constants, passed at run time so that the compiler neither
// turns the multiply-high into a shift nor splits a bias and a mask into
// two instructions (one LOP3 each, their biases kept apart so that no
// shared XOR is factored out): even lanes (v ^ 0x00800080) & 0x00ff00ff,
// odd lanes (v ^ 0x80008000) & 0xff00ff00, moved down by a multiply-high
// by 2^24. Written in as literals, they cost the general nine-tap path
// 12-13% at the probe's shape on an H100 (the run path, within the spread).
struct Lanes {
    uint32_t bias_even, even, bias_odd, odd, down;
};

// x [S][I][P] int8, out [S][O][N] bf16 (see above), TAPS taps; RUNS: nine
// in three runs of three neighbouring offsets.
template <int TAPS, bool RUNS>
__global__ void __launch_bounds__(AFCM_SL_THREADS, 2)
slice_sum_kernel(const int8_t* __restrict__ x, __nv_bfloat16* __restrict__ out, int S, int O,
                 int I, int P, int N, const __grid_constant__ SlicePlan pl,
                 const __grid_constant__ SliceTaps tp, const Lanes ln) {
    extern __shared__ unsigned char sl_smem_raw[];
    __shared__ __align__(8) uint64_t full[AFCM_SL_MAX_STAGES];    // an x stage landed
    __shared__ __align__(8) uint64_t empty[AFCM_SL_MAX_STAGES];   // ... and was summed
    unsigned char* smem = sl_smem_raw + ((128 - afcm::smem_addr(sl_smem_raw) % 128) % 128);
    unsigned char* in_ring = smem;
    unsigned char* out_ring = in_ring + pl.stages * pl.in_bytes;
    unsigned char* zeros = out_ring + 2 * pl.out_bytes;
    const int tid = threadIdx.x;
    const int R = pl.rows;
    const int live = O < I ? O : I;
    const int per_s = (O + R - 1) / R;
    const long long units = static_cast<long long>(S) * per_s;

    for (int k = tid; k < AFCM_SL_ZERO / 16; k += AFCM_SL_THREADS)
        reinterpret_cast<uint4*>(zeros)[k] = make_uint4(0, 0, 0, 0);
    if (tid == 0) {
        for (int k = 0; k < pl.stages; ++k) {
            mbar_init(&full[k], 1);
            mbar_init(&empty[k], AFCM_SL_SUMMERS / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    afcm::fence_proxy_async();                  // the zeros, visible to the bulk stores
    __syncthreads();

    if (tid < 32) {
        // ---------------------------------------------------------- loader
        if (tid != 0) return;
        int k = 0;                              // the CTA's units with live rows so far
        for (long long u = blockIdx.x; u < units; u += gridDim.x) {
            const int s = static_cast<int>(u / per_s);
            const int o0 = static_cast<int>(u - static_cast<long long>(s) * per_s) * R;
            const int o1 = o0 + R < O ? o0 + R : O;
            const int l1 = o1 < live ? o1 : live;
            if (o0 < l1) {       // x rows o0 .. l1 - 1, once stage k - stages is summed
                const int st = k % pl.stages;
                if (k >= pl.stages) mbar_wait(&empty[st], (k / pl.stages + 1) & 1);
                const int8_t* src = x + (static_cast<size_t>(s) * I + o0) * P;
                const uint32_t len = static_cast<uint32_t>(l1 - o0) * P;
                const uint32_t mis = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(src) & 15);
                const uint32_t head = (16 - mis) & 15, body = (len - head) & ~15u;
                const uint32_t tail = len - head - body;   // 0 or 8, as head
                unsigned char* dst = in_ring + st * pl.in_bytes + mis;   // the span's first byte
                if (head) *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
                if (tail)
                    *reinterpret_cast<uint2*>(dst + head + body) =
                        *reinterpret_cast<const uint2*>(src + head + body);
                afcm::fence_proxy_async();      // generic writes to the stage before the copy's
                mbar_expect_tx(&full[st], body);
                if (body) bulk_load(dst + head, src + head, body, &full[st]);
                ++k;
            }
            if (l1 < o1) {                      // rows max(o0, live) .. o1 - 1 are zero
                const int d0 = o0 > live ? o0 : live;
                unsigned char* z = reinterpret_cast<unsigned char*>(
                    out + (static_cast<size_t>(s) * O + d0) * N);
                for (long long left = static_cast<long long>(o1 - d0) * N * 2; left > 0;
                     left -= AFCM_SL_ZERO, z += AFCM_SL_ZERO)
                    bulk_store(z, zeros, left < AFCM_SL_ZERO ? static_cast<uint32_t>(left)
                                                             : AFCM_SL_ZERO);
                bulk_commit();
                bulk_wait_read<8>();            // a bound on this thread's groups in flight
            }
        }
        bulk_wait<0>();
        return;
    }

    // --------------------------------------------------------- summing warps
    const int ct = tid - 32, warp = ct / 32, lane = ct % 32;
    const int nq = N / 4;                                 // items of four columns a row
    const int dr = AFCM_SL_SUMMERS / nq, dq = AFCM_SL_SUMMERS % nq;
    constexpr int LOADS = RUNS ? 3 : TAPS;               // word pairs (triples) an item
    int word[LOADS], shift[LOADS];
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
        word[j] = tp.word[j];
        shift[j] = tp.shift[j];
    }
    // the four columns whose bytes of tap offset 0 start at `at` (4-byte
    // aligned), as four bf16
    auto sum4 = [&](const unsigned char* at) {
        uint32_t even = 0, odd = 0;
#pragma unroll
        for (int j = 0; j < LOADS; ++j) {
            const uint32_t w0 = lds32(at + word[j]), w1 = lds32(at + word[j] + 4);
            if (RUNS) {
                // a run of three: bytes sh .. sh + 7 as two words, then the
                // four byte pairs (sh + m, sh + m + 2), m = 0 .. 3, in the
                // even lanes: the even columns take m = 0, 1, 2 and the
                // odd ones m = 1, 2, 3
                const uint32_t w2 = lds32(at + word[j] + 8);
                const uint32_t a = __funnelshift_r(w0, w1, shift[j]);
                const uint32_t b = __funnelshift_r(w1, w2, shift[j]);
                const uint32_t e0 = (a ^ ln.bias_even) & ln.even;
                const uint32_t e1 = (__funnelshift_r(a, b, 8) ^ ln.bias_even) & ln.even;
                const uint32_t e2 = (__funnelshift_r(a, b, 16) ^ ln.bias_even) & ln.even;
                const uint32_t e3 = (__funnelshift_r(a, b, 24) ^ ln.bias_even) & ln.even;
                const uint32_t mid = e1 + e2;
                even += e0 + mid;
                odd += mid + e3;
            } else {
                const uint32_t v = __funnelshift_r(w0, w1, shift[j]);
                even += (v ^ ln.bias_even) & ln.even;
                odd += __umulhi((v ^ ln.bias_odd) & ln.odd, ln.down);
            }
        }
        constexpr int bias = 128 * TAPS;                  // a lane's bias
        const __nv_bfloat162 lo = __floats2bfloat162_rn(
            __int2float_rn(static_cast<int>(even & 0xffffu) - bias),
            __int2float_rn(static_cast<int>(odd & 0xffffu) - bias));
        const __nv_bfloat162 hi = __floats2bfloat162_rn(
            __int2float_rn(static_cast<int>(even >> 16) - bias),
            __int2float_rn(static_cast<int>(odd >> 16) - bias));
        return make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                          *reinterpret_cast<const uint32_t*>(&hi));
    };
    int k = 0;
    for (long long u = blockIdx.x; u < units; u += gridDim.x) {
        const int s = static_cast<int>(u / per_s);
        const int o0 = static_cast<int>(u - static_cast<long long>(s) * per_s) * R;
        const int o1 = o0 + R < O ? o0 + R : O;
        const int l1 = o1 < live ? o1 : live;
        if (o0 >= l1) continue;
        const int st = k % pl.stages;
        unsigned char* staged = out_ring + (k & 1) * pl.out_bytes;
        mbar_wait(&full[st], (k / pl.stages) & 1);
        bar_sync(BAR_FREE, AFCM_SL_SUMMERS);   // the store of unit k - 2 has read `staged`
        const unsigned char* rows =
            in_ring + st * pl.in_bytes +
            (reinterpret_cast<uintptr_t>(x + (static_cast<size_t>(s) * I + o0) * P) & 15);
        // two items a pass, for the loads and sums of one to overlap the
        // other's (the second one, where there is none, sums the first
        // again and stores nothing)
        const int items = (l1 - o0) * nq;
        int r = ct / nq, q = ct - r * nq;
        for (int it = ct; it < items; it += 2 * AFCM_SL_SUMMERS) {
            int r2 = r + dr, q2 = q + dq;
            if (q2 >= nq) {
                q2 -= nq;
                ++r2;
            }
            const bool second = it + AFCM_SL_SUMMERS < items;
            const uint2 a = sum4(rows + static_cast<size_t>(r) * P + 4 * q);
            const uint2 b = sum4(rows + static_cast<size_t>(second ? r2 : r) * P +
                                 4 * (second ? q2 : q));
            *reinterpret_cast<uint2*>(staged + static_cast<size_t>(r) * N * 2 + 8 * q) = a;
            if (second)
                *reinterpret_cast<uint2*>(staged + static_cast<size_t>(r2) * N * 2 + 8 * q2) = b;
            r = r2 + dr;
            q = q2 + dq;
            if (q >= nq) {
                q -= nq;
                ++r;
            }
        }
        afcm::fence_proxy_async();              // the staged rows, visible to the bulk store
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);   // this warp is done with the x stage
        if (warp == 0) {
            bar_sync(BAR_WRITTEN, AFCM_SL_SUMMERS);
            if (lane == 0) {
                bulk_store(out + (static_cast<size_t>(s) * O + o0) * N, staged,
                           static_cast<uint32_t>(l1 - o0) * N * 2);
                bulk_commit();
                bulk_wait_read<1>();            // unit k - 1's store has read its buffer
            }
            __syncwarp();
        } else {
            bar_arrive(BAR_WRITTEN, AFCM_SL_SUMMERS);
        }
        ++k;
    }
    if (ct == 0) bulk_wait<0>();
}

// A 3-D int8 tensor map: dims innermost first, strides of dims 1 and 2 in
// bytes, zero fill outside the tensor.
bool encode_map(CUtensorMap* map, const void* base, const cuuint64_t (&dims)[3],
                const cuuint64_t (&strides)[2], const cuuint32_t (&box)[3],
                CUtensorMapSwizzle swizzle) {
    static PFN_cuTensorMapEncodeTiled encode = [] {
        void* fn = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
                cudaSuccess ||
            found != cudaDriverEntryPointSuccess)
            fn = nullptr;
        return reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
    }();
    const cuuint32_t unit[3] = {1, 1, 1};
    return encode &&
           encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base), dims, strides,
                  box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename OutT, bool RAW>
int launch_taps(const void* x, void* out, int s, int o, int i, int p, int n, int piece,
                const CUtensorMap& wmap, const CUtensorMap& xmap, const Plan& pl,
                cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        taps_matmul_kernel<OutT, RAW>, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    int device = 0, sms = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&device);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_tiles = (n + BN - 1) / BN;
    const long long tiles = static_cast<long long>(n_tiles) * (o / BM) * s;
    if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const int grid = static_cast<int>(tiles < sms ? tiles : sms);   // one CTA an SM
    taps_matmul_kernel<OutT, RAW><<<grid, THREADS, pl.smem, stream>>>(
        static_cast<const int8_t*>(x), static_cast<OutT*>(out), o, i, p, n, n_tiles,
        static_cast<int>(tiles), piece, wmap, xmap, pl);
    return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* ptr, uintptr_t bytes) {
    return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace

extern "C" {

// The plan of a call (make_plan) as ints: groups, span, ksub, a_bytes,
// slice_bytes, stage_bytes, xboxes, xw, x_tma, b_sw32, stages, raws,
// epi_bytes, smem, then tap[taps], off[taps] and base[groups] (14 + 3 *
// taps ints at most).
// i: bytes of K; tma_ok: raw x may come by tensor map (p a multiple of 16,
// x 16-byte aligned). 0, or an error if there is none.
int afcm_taps_plan(const int* offs, int taps, int i, int raw, int tma_ok, int out_bf16,
                   int* info) {
    if (taps < 1 || taps > AFCM_P8_MAX_TAPS || i < 64 || i % 64)
        return static_cast<int>(cudaErrorInvalidValue);
    for (int k = 0; k < taps; ++k)
        if (offs[k] < 0) return static_cast<int>(cudaErrorInvalidValue);
    Plan pl;
    if (!make_plan(offs, taps, i, raw != 0, tma_ok != 0, out_bf16 ? 2 : 4, pl))
        return static_cast<int>(cudaErrorInvalidValue);
    const int head[14] = {pl.groups,      pl.span,   pl.ksub,   pl.a_bytes,   pl.slice_bytes,
                          pl.stage_bytes, pl.xboxes, pl.xw,     pl.x_tma,     pl.b_sw32,
                          pl.stages,      pl.raws,   pl.epi_bytes, pl.smem};
    int k = 0;
    for (int v : head) info[k++] = v;
    for (int j = 0; j < taps; ++j) info[k++] = pl.tap[j];
    for (int j = 0; j < taps; ++j) info[k++] = pl.off[j];
    for (int g = 0; g < pl.groups; ++g) info[k++] = pl.base[g];
    return 0;
}

// out[s][o][n] = sum_tap w[tap][o][i] @ X_s (see taps_matmul_kernel).
//   w: int8 [taps][o][i]; offs: host array of `taps` column offsets.
//   raw = 1: x int8 [s][i][p]; raw = 0: x int8 [s][p][i].
//   out_bf16 = 0: out int32 [s][o][n]; 1: bf16.
// o and n multiples of 128, i of 64, p of 8; off + n <= p for every tap;
// w, out and (for raw = 0) x 16-byte aligned, x 8-byte aligned.
int afcm_taps_matmul_int8(const void* w, const void* x, void* out, int s, int o, int i,
                          int p, int n, int taps, const int* offs, int raw, int out_bf16,
                          void* stream) {
    if (s < 1 || o < BM || o % BM || n < 128 || n % 128 || i < 64 || i % 64 || p % 8 ||
        taps < 1 || taps > AFCM_P8_MAX_TAPS || !aligned(w, 16) || !aligned(out, 16) ||
        !aligned(x, raw ? 8 : 16))
        return static_cast<int>(cudaErrorInvalidValue);
    for (int k = 0; k < taps; ++k)
        if (offs[k] < 0 || offs[k] + n > p) return static_cast<int>(cudaErrorInvalidValue);
    const bool aligned16 = p % 16 == 0 && aligned(x, 16);
    Plan pl;
    if (!make_plan(offs, taps, i, raw != 0, aligned16, out_bf16 ? 2 : 4, pl))
        return static_cast<int>(cudaErrorInvalidValue);
    // w as {i, o, taps}: a step's box is 32 bytes of k, 128 rows and the
    // group's taps (all of them, or one)
    CUtensorMap wmap, xmap;
    const cuuint64_t wdims[3] = {static_cast<cuuint64_t>(i), static_cast<cuuint64_t>(o),
                                 static_cast<cuuint64_t>(taps)};
    const cuuint64_t wstrides[2] = {static_cast<cuuint64_t>(i),
                                    static_cast<cuuint64_t>(i) * o};
    const cuuint32_t wbox[3] = {KC, BM, static_cast<cuuint32_t>(pl.groups == 1 ? taps : 1)};
    if (!encode_map(&wmap, w, wdims, wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_32B))
        return static_cast<int>(cudaErrorInvalidValue);
    xmap = wmap;                                // unused for raw x by cp.async
    if (raw && pl.x_tma) {
        // raw x as {p, i, s}: boxes of xw columns and a step's k rows
        const cuuint64_t xdims[3] = {static_cast<cuuint64_t>(p), static_cast<cuuint64_t>(i),
                                     static_cast<cuuint64_t>(s)};
        const cuuint64_t xstrides[2] = {static_cast<cuuint64_t>(p),
                                        static_cast<cuuint64_t>(p) * i};
        const cuuint32_t xbox[3] = {static_cast<cuuint32_t>(pl.xw),
                                    static_cast<cuuint32_t>(KC * pl.ksub), 1};
        if (!encode_map(&xmap, x, xdims, xstrides, xbox, CU_TENSOR_MAP_SWIZZLE_NONE))
            return static_cast<int>(cudaErrorInvalidValue);
    } else if (!raw) {
        // K-major x as {i, p, s}: boxes of 32 (swizzled) or 16 bytes of k
        // and xw rows
        const cuuint64_t xdims[3] = {static_cast<cuuint64_t>(i), static_cast<cuuint64_t>(p),
                                     static_cast<cuuint64_t>(s)};
        const cuuint64_t xstrides[2] = {static_cast<cuuint64_t>(i),
                                        static_cast<cuuint64_t>(i) * p};
        const cuuint32_t xbox[3] = {pl.b_sw32 ? 32u : 16u, static_cast<cuuint32_t>(pl.xw), 1};
        if (!encode_map(&xmap, x, xdims, xstrides, xbox,
                        pl.b_sw32 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_NONE))
            return static_cast<int>(cudaErrorInvalidValue);
    }
    const int piece = aligned16 ? 16 : 8;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (raw)
        return out_bf16 ? launch_taps<__nv_bfloat16, true>(x, out, s, o, i, p, n, piece, wmap,
                                                            xmap, pl, st)
                        : launch_taps<int, true>(x, out, s, o, i, p, n, piece, wmap, xmap, pl,
                                                 st);
    return out_bf16 ? launch_taps<__nv_bfloat16, false>(x, out, s, o, i, p, n, piece, wmap,
                                                         xmap, pl, st)
                    : launch_taps<int, false>(x, out, s, o, i, p, n, piece, wmap, xmap, pl, st);
}

// The plan of a slice-sum call (make_slice_plan) as six ints: rows,
// stages, ctas, in_bytes, out_bytes, smem. 0, or an error if there is none.
int afcm_slice_sum_plan(int o, int i, int p, int n, int* info) {
    SlicePlan pl;
    if (o < 1 || i < 1 || n < 8 || n % 8 || p % 8 || p < n || !make_slice_plan(p, n, pl))
        return static_cast<int>(cudaErrorInvalidValue);
    const int v[6] = {pl.rows, pl.stages, pl.ctas, pl.in_bytes, pl.out_bytes, pl.smem};
    for (int k = 0; k < 6; ++k) info[k] = v[k];
    return 0;
}

// out bf16 [s][o][n] = sum_tap int32(x[s][row][off_tap + n]) for row < i,
// zero rows from i to o (slice_sum_kernel). x int8 [s][i][p], 8-byte
// aligned; out 16-byte aligned; n and p multiples of 8; off + n <= p for
// every tap.
int afcm_slice_sum_int8(const void* x, void* out, int s, int o, int i, int p, int n,
                        int taps, const int* offs, void* stream) {
    if (s < 1 || o < 1 || i < 1 || n < 8 || n % 8 || p % 8 || taps < 1 ||
        taps > AFCM_P8_MAX_TAPS || !aligned(x, 8) || !aligned(out, 16))
        return static_cast<int>(cudaErrorInvalidValue);
    int sorted[AFCM_P8_MAX_TAPS];
    for (int k = 0; k < taps; ++k) {            // insertion sort by offset
        if (offs[k] < 0 || offs[k] + n > p) return static_cast<int>(cudaErrorInvalidValue);
        int j = k;
        while (j > 0 && sorted[j - 1] > offs[k]) {
            sorted[j] = sorted[j - 1];
            --j;
        }
        sorted[j] = offs[k];
    }
    bool runs = taps == 9;                      // three runs of three neighbouring offsets
    for (int k = 0; k < taps && runs; ++k) runs = sorted[k] == sorted[k - k % 3] + k % 3;
    SliceTaps tp = {};
    for (int k = 0; k < (runs ? 3 : taps); ++k) {
        const int off = sorted[runs ? 3 * k : k];
        tp.word[k] = off & ~3;
        tp.shift[k] = 8 * (off & 3);
    }
    SlicePlan pl;
    if (!make_slice_plan(p, n, pl)) return static_cast<int>(cudaErrorInvalidValue);
    using Kernel = void (*)(const int8_t*, __nv_bfloat16*, int, int, int, int, int, SlicePlan,
                            SliceTaps, Lanes);
    const Kernel kernels[AFCM_P8_MAX_TAPS] = {
        slice_sum_kernel<1, false>, slice_sum_kernel<2, false>, slice_sum_kernel<3, false>,
        slice_sum_kernel<4, false>, slice_sum_kernel<5, false>, slice_sum_kernel<6, false>,
        slice_sum_kernel<7, false>, slice_sum_kernel<8, false>, slice_sum_kernel<9, false>};
    const Kernel kernel = runs ? slice_sum_kernel<9, true> : kernels[taps - 1];
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
    int device = 0, sms = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&device);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long units = static_cast<long long>(s) * ((o + pl.rows - 1) / pl.rows);
    const long long most = static_cast<long long>(sms) * pl.ctas;
    const int grid = static_cast<int>(units < most ? units : most);
    kernel<<<grid, AFCM_SL_THREADS, pl.smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(x), static_cast<__nv_bfloat16*>(out), s, o, i, p, n, pl, tp,
        Lanes{0x00800080u, 0x00ff00ffu, 0x80008000u, 0xff00ff00u, 1u << 24});
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
