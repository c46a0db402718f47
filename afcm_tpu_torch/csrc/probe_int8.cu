// int8 matrix-rate probes for NVIDIA Hopper (sm_90a).
//
// Replaces two TPU probe kernels:
//   scripts/bench_int8_matmul.py: pallas_stacked -> stacked_mm_kernel (:30-52)
//       o[s] = a @ b[s]                      a [O,I], b [S,I,L] int8 -> int32
//   scripts/diag_int8_kernel.py: make -> kernel (:38-78), four modes
//       o[s] = bf16( sum_tap w[tap] @ x[s][:, off_tap : off_tap + N] )
//       with one tap, nine taps at offset 0, nine taps at off = dy * wp + dx,
//       and `sliceonly`: the nine shifted slices summed without a product.
// Both are one function here: for every s,
//       out[s] = sum_{tap < taps} w[tap] @ x[s][:, off[tap] : off[tap] + N]
// with int32 accumulation, written as int32 or rounded to bf16. Integer
// sums have no rounding, so the result equals the plain version bit for bit.
//
// What they measure on this card: the rate mma.sync.m16n8k32 (s8) reaches
// when the right operand arrives as the caller's matrix has it, [I][L] with
// L contiguous, while the instruction wants k contiguous in both operands
// (conv_int8.cu never meets this: its quantizer writes NHWC). The tile is
// staged raw with cp.async and the bytes are transposed in registers on the
// way to the fragments (mma_s8.cuh: load_frag_b_transposed); a tap's offset
// of 1 or 2 bytes along the contiguous axis folds into that load's address,
// where an unaligned start costs a second shared load and a funnel shift per
// row (8-byte cp.async needs aligned sources, so the copy starts at the
// offset rounded down to 8). A second entry takes the right operand already
// as [S][L][I] and loads fragments as conv_int8.cu does; the difference is
// what that layout buys. What bounds them: at O, I of 128..512 the int32
// output dominates the bytes, and the products run well below the card's
// int8 peak without wgmma; the probes report both.
//
// One CTA (256 threads, 8 warps as 2 x 4 of 64 x 32) computes a 128 x 128
// tile of out[s]; a step is 64 of k for one tap, two steps in flight
// (cp.async double buffer). Shared rows of k-contiguous tiles are padded
// from 64 to 80 bytes and the raw tile's rows to 136 bytes: both make the
// fragment loads free of bank conflicts.
//
// Interface: plain C, loaded with ctypes; launches on the caller's stream
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <stddef.h>
#include <stdint.h>

#include "mma_s8.cuh"

#define AFCM_P8_BM 128         // rows of out per CTA
#define AFCM_P8_BN 128         // columns of out per CTA
#define AFCM_P8_KC 64          // k per step
#define AFCM_P8_THREADS 256
#define AFCM_P8_MAX_TAPS 9

namespace {

constexpr int BM = AFCM_P8_BM;
constexpr int BN = AFCM_P8_BN;
constexpr int KC = AFCM_P8_KC;
constexpr int THREADS = AFCM_P8_THREADS;
constexpr int KROW = KC + 16;              // bytes per shared row, k contiguous
constexpr int NPITCH = BN + 8;             // bytes per shared row, n contiguous
constexpr int NCHUNKS = NPITCH / 8;        // 8-byte copies per raw row
constexpr int A_BYTES = BM * KROW;         // 10240

static_assert(NPITCH % 32 == 8, "rows 4t..4t+3 of a raw tile must fall in distinct banks");
static_assert(THREADS == 256 && BM == 128 && BN == 128, "warp layout: 2 x 4 warps of 64 x 32");

struct Offsets {
    int v[AFCM_P8_MAX_TAPS];
};

template <typename OutT> struct Store;

template <> struct Store<int> {
    // eight neighbouring columns of one row
    static __device__ __forceinline__ void eight(int* p, const int (&v)[8]) {
        reinterpret_cast<int4*>(p)[0] = make_int4(v[0], v[1], v[2], v[3]);
        reinterpret_cast<int4*>(p)[1] = make_int4(v[4], v[5], v[6], v[7]);
    }
    static __device__ __forceinline__ void two(int* p, int v0, int v1) {
        *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
    }
};

// int32 -> float -> bf16, both round to nearest even, as
// acc.to(float32).to(bfloat16) rounds.
__device__ __forceinline__ __nv_bfloat16 to_bf16(int v) {
    return __float2bfloat16_rn(__int2float_rn(v));
}

template <> struct Store<__nv_bfloat16> {
    static __device__ __forceinline__ void eight(__nv_bfloat16* p, const int (&v)[8]) {
        __align__(16) __nv_bfloat162 h[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) h[i] = __halves2bfloat162(to_bf16(v[2 * i]), to_bf16(v[2 * i + 1]));
        *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
    }
    static __device__ __forceinline__ void two(__nv_bfloat16* p, int v0, int v1) {
        *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(to_bf16(v0), to_bf16(v1));
    }
};

// out[s][O][N] = sum_tap w[tap][O][I] @ X_s, with
//   RAW:  x [S][I][P], X_s = x[s][:, off : off + N]   (n contiguous)
//   !RAW: x [S][P][I], X_s = x[s][off : off + N, :]^T  (k contiguous)
template <typename OutT, bool RAW>
__global__ void __launch_bounds__(THREADS, 2)
taps_matmul_kernel(const int8_t* __restrict__ w, const int8_t* __restrict__ x,
                   OutT* __restrict__ out, int O, int I, int P, int N, int taps,
                   const Offsets offs) {
    constexpr int B_BYTES = RAW ? KC * NPITCH : BN * KROW;
    __shared__ __align__(16) unsigned char a_smem[2][A_BYTES];
    __shared__ __align__(16) unsigned char b_smem[2][B_BYTES];

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int wm = warp >> 2, wn = warp & 3;
    const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, s = blockIdx.z;
    const int8_t* xs = x + static_cast<size_t>(s) * I * P;

    int acc[4][4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0;

    const int steps = (I / KC) * taps;

    auto load = [&](int step, int stage) {
        const int ks = step / taps, tap = step - ks * taps;
        const int off = offs.v[tap], k0 = ks * KC;
        unsigned char* as = a_smem[stage];
        unsigned char* bs = b_smem[stage];
        for (int v = tid; v < BM * (KC / 16); v += THREADS) {
            const int m = v / (KC / 16), q = v % (KC / 16);
            afcm::cp_async16(as + m * KROW + q * 16,
                             w + (static_cast<size_t>(tap) * O + m0 + m) * I + k0 + q * 16);
        }
        if (RAW) {
            const int c0 = n0 + (off & ~7);
            for (int v = tid; v < KC * NCHUNKS; v += THREADS) {
                const int k = v / NCHUNKS, q = v % NCHUNKS;
                unsigned char* dst = bs + k * NPITCH + q * 8;
                const int col = c0 + q * 8;
                if (col + 8 <= P)
                    afcm::cp_async8(dst, xs + static_cast<size_t>(k0 + k) * P + col);
                else                        // past the row: columns no output reads
                    *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
            }
        } else {
            for (int v = tid; v < BN * (KC / 16); v += THREADS) {
                const int n = v / (KC / 16), q = v % (KC / 16);
                afcm::cp_async16(bs + n * KROW + q * 16,
                                 xs + static_cast<size_t>(n0 + off + n) * I + k0 + q * 16);
            }
        }
        afcm::cp_async_commit();
    };

    load(0, 0);
    for (int step = 0; step < steps; ++step) {
        const int stage = step & 1;
        if (step + 1 < steps) {
            load(step + 1, stage ^ 1);
            afcm::cp_async_wait<1>();
        } else {
            afcm::cp_async_wait<0>();
        }
        __syncthreads();
        const unsigned char* as = a_smem[stage];
        const unsigned char* bs = b_smem[stage];
        const int shift = offs.v[step % taps] & 7;
#pragma unroll
        for (int kk = 0; kk < KC / 32; ++kk) {
            uint32_t a[4][4], b[4][2];
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)
                afcm::load_frag_a(a[mt], as + (wm * 64 + mt * 16 + g) * KROW + kk * 32 + t * 4,
                                  KROW);
            if (RAW) {
                afcm::load_frag_b_transposed(b, bs + kk * 32 * NPITCH, NPITCH,
                                             wn * 32 + 4 * g + shift, t);
            } else {
#pragma unroll
                for (int nt = 0; nt < 4; ++nt)
                    afcm::load_frag_b(b[nt], bs + (wn * 32 + nt * 8 + g) * KROW + kk * 32 + t * 4);
            }
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)
#pragma unroll
                for (int nt = 0; nt < 4; ++nt) afcm::mma_s8(acc[mt][nt], a[mt], b[nt]);
        }
        __syncthreads();                    // the stage is free for the load after next
    }

    OutT* os = out + static_cast<size_t>(s) * O * N;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
            const int row = m0 + wm * 64 + mt * 16 + g + hi * 8;
            OutT* orow = os + static_cast<size_t>(row) * N + n0 + wn * 32;
            if (RAW) {
                // n-tile j's columns 2t, 2t+1 are the tile's 8t + j, 8t + 4 + j
                int v[8];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    v[j] = acc[mt][j][hi * 2 + 0];
                    v[4 + j] = acc[mt][j][hi * 2 + 1];
                }
                Store<OutT>::eight(orow + 8 * t, v);
            } else {
#pragma unroll
                for (int nt = 0; nt < 4; ++nt)
                    Store<OutT>::two(orow + nt * 8 + 2 * t, acc[mt][nt][hi * 2 + 0],
                                     acc[mt][nt][hi * 2 + 1]);
            }
        }
    }
}

// `sliceonly`: out[s][o][n] = bf16( sum_tap int32(x[s][o][off_tap + n]) ) for
// o < I, zero rows from I to O; no product. One thread sums eight
// neighbouring columns: per tap two aligned 8-byte loads and a funnel shift
// give the eight bytes that start at any offset.
__global__ void __launch_bounds__(256)
slice_sum_kernel(const int8_t* __restrict__ x, __nv_bfloat16* __restrict__ out,
                 int O, int I, int P, int N, int taps, const Offsets offs) {
    const int n8 = N / 8;
    for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
         e < static_cast<long long>(O) * n8;
         e += static_cast<long long>(gridDim.x) * blockDim.x) {
        const int o = static_cast<int>(e / n8), n = static_cast<int>(e % n8) * 8;
        const int s = blockIdx.y;
        int sum[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        if (o < I) {
            const int8_t* row = x + (static_cast<size_t>(s) * I + o) * P;
            for (int tap = 0; tap < taps; ++tap) {
                const int c = offs.v[tap] + n, sh = c & 7;
                const unsigned long long* p =
                    reinterpret_cast<const unsigned long long*>(row + (c - sh));
                unsigned long long lo = p[0];
                if (sh) {
                    const unsigned long long hi = (c - sh + 16 <= P) ? p[1] : 0ull;
                    lo = (lo >> (8 * sh)) | (hi << (64 - 8 * sh));
                }
#pragma unroll
                for (int i = 0; i < 8; ++i)
                    sum[i] += static_cast<int>(static_cast<signed char>((lo >> (8 * i)) & 0xff));
            }
        }
        Store<__nv_bfloat16>::eight(out + (static_cast<size_t>(s) * O + o) * N + n, sum);
    }
}

template <typename OutT, bool RAW>
int launch_taps(const void* w, const void* x, void* out, int s, int o, int i, int p, int n,
                int taps, const Offsets& offs, cudaStream_t stream) {
    dim3 grid(n / BN, o / BM, s);
    taps_matmul_kernel<OutT, RAW><<<grid, THREADS, 0, stream>>>(
        static_cast<const int8_t*>(w), static_cast<const int8_t*>(x),
        static_cast<OutT*>(out), o, i, p, n, taps, offs);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out[s][o][n] = sum_tap w[tap][o][i] @ X_s (see taps_matmul_kernel).
//   w: int8 [taps][o][i]; offs: host array of `taps` column offsets.
//   raw = 1: x int8 [s][i][p]; raw = 0: x int8 [s][p][i].
//   out_bf16 = 0: out int32 [s][o][n]; 1: bf16.
// o and n multiples of 128, i of 64, p of 8; off + n <= p for every tap.
int afcm_taps_matmul_int8(const void* w, const void* x, void* out, int s, int o, int i,
                          int p, int n, int taps, const int* offs, int raw, int out_bf16,
                          void* stream) {
    if (s < 1 || s > 65535 || o < BM || o % BM || n < BN || n % BN || i < KC || i % KC ||
        p % 8 || taps < 1 || taps > AFCM_P8_MAX_TAPS || o / BM > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    Offsets of = {};
    for (int k = 0; k < taps; ++k) {
        if (offs[k] < 0 || offs[k] + n > p) return static_cast<int>(cudaErrorInvalidValue);
        of.v[k] = offs[k];
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (raw)
        return out_bf16 ? launch_taps<__nv_bfloat16, true>(w, x, out, s, o, i, p, n, taps, of, st)
                        : launch_taps<int, true>(w, x, out, s, o, i, p, n, taps, of, st);
    return out_bf16 ? launch_taps<__nv_bfloat16, false>(w, x, out, s, o, i, p, n, taps, of, st)
                    : launch_taps<int, false>(w, x, out, s, o, i, p, n, taps, of, st);
}

// out bf16 [s][o][n] = sum_tap int32(x[s][row][off_tap + n]) for row < i,
// zero rows from i to o. x int8 [s][i][p]; n and p multiples of 8.
int afcm_slice_sum_int8(const void* x, void* out, int s, int o, int i, int p, int n,
                        int taps, const int* offs, void* stream) {
    if (s < 1 || s > 65535 || o < 1 || i < 1 || n < 8 || n % 8 || p % 8 || taps < 1 ||
        taps > AFCM_P8_MAX_TAPS)
        return static_cast<int>(cudaErrorInvalidValue);
    Offsets of = {};
    for (int k = 0; k < taps; ++k) {
        if (offs[k] < 0 || offs[k] + n > p) return static_cast<int>(cudaErrorInvalidValue);
        of.v[k] = offs[k];
    }
    const long long items = static_cast<long long>(o) * (n / 8);
    const int blocks = static_cast<int>((items + 255) / 256 < 65535 ? (items + 255) / 256 : 65535);
    slice_sum_kernel<<<dim3(blocks, s), 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(x), static_cast<__nv_bfloat16*>(out), o, i, p, n, taps, of);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
