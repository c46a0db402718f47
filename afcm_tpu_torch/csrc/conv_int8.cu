// int8 3x3 convolution with a dequantizing epilogue, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel afcm_tpu/ops/pallas/conv_int8.py (conv3x3_int8 ->
// _conv_int8_call -> _make_kernel, :129-156). It computes what that kernel's
// body computes, exactly as afcm_tpu_torch/ops/cuda/conv_int8.py:
// int8_conv_plain does on the same quantized inputs:
//
//   acc[n,o,h,w] = sum_{dy,dx,i} wq[dy,dx,o,i] * xq[n,i,h+dy,w+dx]   (int32)
//   y[n,o,h,w]   = bf16( float(acc) * scale[n,o] )
//
// Integer accumulation has no rounding, so the result equals the plain
// version's bit for bit.
//
// What bounds it: operations. At the serving path's shapes (512 -> 512
// channels, 38^2 and 54^2 outputs, batch 16) a call does 109 and 220 G int8
// operations over 39 and 76 MB, thousands of operations per byte, so the
// design is about keeping the tensor cores fed:
//
// * The product is an implicit GEMM (M = output channels, N = output pixels
//   of one sample, K = 9 taps x input channels) on wgmma.mma_async
//   m64nNk32 s8 x s8 -> s32, both operands read from shared memory, the
//   64 x N sums of a CTA's one warpgroup in registers over the whole K loop.
// * Operands lie in shared memory without swizzle, as core matrices of 8
//   rows x 16 bytes of K (wgmma_s8.cuh). The input patch is stored as
//   [K chunk of 16 B][patch row][patch column][16 B]: eight neighbouring
//   pixels of a row are one core matrix, the stride between core matrices
//   along N is the patch's row pitch, and tap (dy, dx) is the same patch
//   read from a start address shifted by dy rows and dx pixels, always a
//   multiple of 16 bytes. So a pixel tile is 8 columns wide and R = N / 8
//   rows high; R is 18 or 20 (N = 144 or 160), whichever covers the output's
//   rows with less idle work (38 rows: 2 x 20, 54: 3 x 18, 36: 2 x 18).
// * A ring of four stages in shared memory, one per 32 input channels
//   (the nine taps' weights [9][2][64][16 B] = 18 KB and the patch
//   [2][R+2][10][16 B] = 6-7 KB): the loads of the next three steps are in
//   flight while the 9 products of a step run. Two CTAs (2 x 100 KB) share
//   an SM, so one's prologue, epilogue and barriers overlap the other's
//   products.
// * Measured with the products taken out, the kernel was bound by its loads
//   when the weights came as 16-byte cp.async pieces out of [9][O'][I']
//   rows (32 useful bytes per 512-byte row and step). The weight quantizer
//   therefore writes them tiled, one contiguous 18 KB block per (64 output
//   channels, 32 input channels) in the very order shared memory holds
//   them, and one thread brings a block in with one bulk copy
//   (cp.async.bulk) that reports to an mbarrier. The patch stays on
//   cp.async with zero fill: 32 bytes per pixel out of the NHWC rows. A
//   thread brings the same pieces in every step, so it works their
//   addresses out once, before the K loop (PatchPieces).
// * The epilogue dequantizes from the accumulator registers and stores bf16
//   pairs straight to NCHW: a tile row is 8 pixels = 16 bytes, which four
//   lanes write together.
//
// Layout (made by the quantizer kernels of quantize_int8.cu, so that K is
// contiguous for both operands and no load needs a mask inside the image):
//   x  int8 [N][H+2p][W+2p][I']  NHWC with a zero halo of p pixels,
//                                I' = I rounded up to 32 with zeros
//   w  int8 [O'/64][I'/32][9][2][64][16]   one block per (64 output channels,
//                                32 input channels): tap, K chunk of 16
//                                bytes, channel, byte; O' = O rounded up to
//                                128 with zeros
//   scale fp32 [N][O]            x_scale[n] * w_scale[o] (* extra_scale[n,o])
//   y  bf16 [N][O][Ho][Wo]       NCHW (the next op reads NCHW), Ho = H+2p-2
//
// Interface: plain C, loaded with ctypes; launches on the caller's stream
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <stddef.h>
#include <stdint.h>

#include "wgmma_s8.cuh"

#define AFCM_C8_BM 64         // output channels per CTA: one warpgroup's M
#define AFCM_C8_M_ALIGN 128   // the packed weights' channel pad
#define AFCM_C8_TW 8          // output columns per CTA: one core matrix
#define AFCM_C8_KC 32         // input channels per step: one product's K
#define AFCM_C8_THREADS 128
#define AFCM_C8_STAGES 4

namespace {

constexpr int BM = AFCM_C8_BM;
constexpr int TW = AFCM_C8_TW;
constexpr int KC = AFCM_C8_KC;
constexpr int PW = TW + 2;                     // patch columns
constexpr int THREADS = AFCM_C8_THREADS;
constexpr int STAGES = AFCM_C8_STAGES;
constexpr int W_TAP_BYTES = 2 * BM * 16;       // one tap: [2 K chunks][64][16 B]
constexpr int W_BYTES = 9 * W_TAP_BYTES;       // 18432

template <int R> struct Tile {
    static constexpr int PH = R + 2;                       // patch rows
    static constexpr int X_CHUNK_BYTES = PH * PW * 16;     // one K chunk of the patch
    static constexpr int X_BYTES = 2 * X_CHUNK_BYTES;
    static constexpr int STAGE_BYTES = W_BYTES + X_BYTES;
    static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
};

static_assert(2 * (Tile<20>::SMEM_BYTES + 1024) <= 228 * 1024, "two CTAs share an SM");

using afcm::cp_async16_zfill;
using afcm::cp_async_commit;
using afcm::cp_async_wait;
using afcm::mbar_expect_tx;
using afcm::mbar_init;
using afcm::mbar_wait;

// A thread's share of a step's patch: PIECES 16-byte pieces, the same ones
// in every step, so their places are worked out once. to: the byte offset in
// the stage's patch [2][PH][PW][16], -1 for no piece; from: the byte offset
// of the piece's first channel block in the sample, -1 beyond the image (a
// masked output's input, filled with zeros).
template <int R> struct PatchPieces {
    static constexpr int COUNT = Tile<R>::PH * PW * 2;
    static constexpr int PIECES = (COUNT + THREADS - 1) / THREADS;
    int to[PIECES], from[PIECES];

    __device__ __forceinline__ PatchPieces(int Ip, int Hp, int Wp, int h0, int w0, int tid) {
#pragma unroll
        for (int j = 0; j < PIECES; ++j) {
            const int v = tid + j * THREADS;
            const int kc = v & 1, pix = v >> 1;
            const int r = pix / PW, c = pix % PW;
            const int hh = h0 + r, ww = w0 + c;
            to[j] = v < COUNT ? ((kc * Tile<R>::PH + r) * PW + c) * 16 : -1;
            from[j] = hh < Hp && ww < Wp ? (hh * Wp + ww) * Ip + kc * 16 : -1;
        }
    }
};

// Stage step `step` (input channels [32 step, 32 step + 32)) in `slot`: one
// thread asks for the weights' block, all bring the patch.
template <int R>
__device__ __forceinline__ void load_stage(unsigned char* slot, uint64_t* bar,
                                           const int8_t* __restrict__ w_cta,
                                           const int8_t* __restrict__ xn, int step,
                                           const PatchPieces<R>& pieces, int tid) {
    if (tid == 0) {
        mbar_expect_tx(bar, W_BYTES);
        afcm::bulk_load(slot, w_cta + static_cast<size_t>(step) * W_BYTES, W_BYTES, bar);
    }
    unsigned char* xs = slot + W_BYTES;         // [2][PH][PW][16]
    const int8_t* xk = xn + step * KC;
#pragma unroll
    for (int j = 0; j < PatchPieces<R>::PIECES; ++j) {
        if (pieces.to[j] < 0) continue;
        const bool in = pieces.from[j] >= 0;
        cp_async16_zfill(xs + pieces.to[j], in ? xk + pieces.from[j] : xn, in ? 16u : 0u);
    }
}

template <int R>
__global__ void __launch_bounds__(THREADS, 2)
conv3x3_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scale, __nv_bfloat16* __restrict__ y,
                    int O, int Ip, int Hp, int Wp, int Ho, int Wo, int tiles_w) {
    constexpr int N = 8 * R;
    constexpr int STAGE_BYTES = Tile<R>::STAGE_BYTES;
    extern __shared__ __align__(128) unsigned char smem[];
    __shared__ __align__(8) uint64_t full[STAGES];      // a stage's weights have landed

    const int tid = threadIdx.x;
    const int h0 = (blockIdx.x / tiles_w) * R;
    const int w0 = (blockIdx.x % tiles_w) * TW;
    const int m0 = blockIdx.y * BM;
    const int n = blockIdx.z;

    int acc[N / 2];
#pragma unroll
    for (int r = 0; r < N / 2; ++r) acc[r] = 0;

    const int steps = Ip / KC;
    const int8_t* xn = x + static_cast<size_t>(n) * Hp * Wp * Ip;
    const int8_t* w_cta = w + static_cast<size_t>(blockIdx.y) * steps * W_BYTES;

    const PatchPieces<R> pieces(Ip, Hp, Wp, h0, w0, tid);

    if (tid == 0) {
#pragma unroll
        for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // Prologue: the first STAGES - 1 steps' loads, one cp.async group each
    // (an empty group where the K loop is shorter).
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < steps)
            load_stage<R>(smem + s * STAGE_BYTES, &full[s], w_cta, xn, s, pieces, tid);
        cp_async_commit();
    }

    // A: one tap's [64][32 B], K chunks 1024 B apart, 8-row groups 128 B apart.
    // B: the patch, K chunks one chunk plane apart, 8-pixel groups one patch
    // row apart. Stage and tap offsets are added to the address field.
    const uint64_t desc_a0 = afcm::wgmma_desc(smem, BM * 16, 128);
    const uint64_t desc_b0 = afcm::wgmma_desc(smem + W_BYTES, Tile<R>::X_CHUNK_BYTES, PW * 16);

    for (int s = 0; s < steps; ++s) {
        cp_async_wait<STAGES - 2>();            // this thread's patch loads of step s landed
        afcm::fence_proxy_async();              // ... and are visible to wgmma
        __syncthreads();                        // everyone's are; step s - 1's slot is free
        const int ahead = s + STAGES - 1;
        if (ahead < steps)
            load_stage<R>(smem + (ahead % STAGES) * STAGE_BYTES, &full[ahead % STAGES], w_cta,
                          xn, ahead, pieces, tid);
        cp_async_commit();
        mbar_wait(&full[s % STAGES], (s / STAGES) & 1);         // step s's weights landed

        const uint32_t slot16 = static_cast<uint32_t>((s % STAGES) * STAGE_BYTES) >> 4;
        afcm::wgmma_fence();
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
            const int dy = tap / 3, dx = tap % 3;
            afcm::wgmma_s8<N>(acc, desc_a0 + slot16 + tap * (W_TAP_BYTES >> 4),
                              desc_b0 + slot16 + (dy * PW + dx));
        }
        afcm::wgmma_commit();
        afcm::wgmma_wait<0>();
    }

    // Epilogue: float(acc) * scale -> bf16 (one multiply, round to nearest
    // even twice, as acc.float() * scale and .to(bfloat16) do), stored from
    // the accumulator fragment: rows g and g + 8 of the warp's 16 channels,
    // pixels (tile row j, columns 2q and 2q + 1).
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, q = lane & 3;
    const int ww = w0 + 2 * q;
    const bool pairs = (Wo & 1) == 0;           // then every pair is 4-byte aligned
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
        const int o = m0 + warp * 16 + g + hi * 8;
        if (o >= O) continue;
        const float sc = scale[static_cast<size_t>(n) * O + o];
        __nv_bfloat16* yo = y + (static_cast<size_t>(n) * O + o) * Ho * Wo;
#pragma unroll
        for (int j = 0; j < R; ++j) {
            const int hh = h0 + j;
            if (hh >= Ho || ww >= Wo) continue;
            const __nv_bfloat16 v0 =
                __float2bfloat16_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * hi]), sc));
            const __nv_bfloat16 v1 =
                __float2bfloat16_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * hi + 1]), sc));
            __nv_bfloat16* dst = yo + static_cast<size_t>(hh) * Wo + ww;
            if (pairs) {
                *reinterpret_cast<__nv_bfloat162*>(dst) = __halves2bfloat162(v0, v1);
            } else {
                dst[0] = v0;
                if (ww + 1 < Wo) dst[1] = v1;
            }
        }
    }
}

template <int R>
int launch(const int8_t* x, const int8_t* w, const float* scale, __nv_bfloat16* y, int n,
           int o, int ip, int hp, int wp, cudaStream_t stream) {
    const int ho = hp - 2, wo = wp - 2;
    const int tiles_w = (wo + TW - 1) / TW;
    const int tiles_h = (ho + R - 1) / R;
    cudaError_t err = cudaFuncSetAttribute(conv3x3_int8_kernel<R>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Tile<R>::SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(tiles_h * tiles_w, (o + BM - 1) / BM, n);
    conv3x3_int8_kernel<R><<<grid, THREADS, Tile<R>::SMEM_BYTES, stream>>>(
        x, w, scale, y, o, ip, hp, wp, ho, wo, tiles_w);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: int8 [n][hp][wp][ip] (zero halo, ip % 32 == 0); w: int8
// [op/64][ip/32][9][2][64][16] (op % 128 == 0, op >= o), 16-byte aligned;
// scale: float [n][o]; y: bf16 [n][o][hp-2][wp-2].
// tile_rows: the pixel tile's height, 18 or 20 (the wrapper's plan).
int afcm_conv3x3_int8(const void* x, const void* w, const void* scale, void* y,
                      int n, int o, int op, int ip, int hp, int wp, int tile_rows,
                      void* stream) {
    if (n < 1 || n > 65535 || o < 1 || op < o || op % AFCM_C8_M_ALIGN != 0 ||
        ip < AFCM_C8_KC || ip % AFCM_C8_KC != 0 || hp < 3 || wp < 3 ||
        (o + BM - 1) / BM > 65535 || reinterpret_cast<uintptr_t>(w) % 16 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int8_t* xs = static_cast<const int8_t*>(x);
    const int8_t* ws = static_cast<const int8_t*>(w);
    const float* ss = static_cast<const float*>(scale);
    __nv_bfloat16* ys = static_cast<__nv_bfloat16*>(y);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (tile_rows == 18) return launch<18>(xs, ws, ss, ys, n, o, ip, hp, wp, st);
    if (tile_rows == 20) return launch<20>(xs, ws, ss, ys, n, o, ip, hp, wp, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
