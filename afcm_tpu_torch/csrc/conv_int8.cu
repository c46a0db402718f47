// int8 3x3 convolution with a dequantizing epilogue, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel afcm_tpu/ops/pallas/conv_int8.py (conv3x3_int8 ->
// _conv_int8_call -> _make_kernel, :129-156). It computes what that kernel's
// body computes, exactly as afcm_tpu_torch/ops/cuda/conv_int8.py:
// conv3x3_int8_plain does on the same quantized inputs:
//
//   acc[n,o,h,w] = sum_{dy,dx,i} wq[dy,dx,o,i] * xq[n,i,h+dy,w+dx]   (int32)
//   y[n,o,h,w]   = bf16( float(acc) * scale[n,o] )
//
// Integer accumulation has no rounding, so the result equals the plain
// version's bit for bit.
//
// What bounds it: operations. At the serving path's shapes (512 -> 512
// channels, 38^2 and 54^2 outputs, batch 16) a call does 109 and 220 G int8
// operations over 39 and 76 MB, thousands of operations per byte. The design is
// the simple one for such a product: an implicit GEMM (M = output channels,
// N = output pixels of one sample, K = 9 taps x input channels) on the
// tensor cores through mma.sync.m16n8k32 (s8 x s8 -> s32; the product, the
// cp.async staging and the fragment loads are in mma_s8.cuh, shared with
// probe_int8.cu). wgmma, TMA,
// ldmatrix, a multi-stage pipeline and a fused quantizer are later work.
//
// Layout (made by the Python wrapper's quantizer, so that K is contiguous
// for both operands and no load needs a mask inside the image):
//   x  int8 [N][H+2p][W+2p][I']  NHWC with a zero halo of p pixels,
//                                I' = I rounded up to 32 with zeros
//   w  int8 [9][O'][I']          tap-major, O' = O rounded up to 128 with zeros
//   scale fp32 [N][O]            x_scale[n] * w_scale[o] (* extra_scale[n,o])
//   y  bf16 [N][O][Ho][Wo]       NCHW (the next op reads NCHW), Ho = H+2p-2
//
// One CTA (256 threads, 8 warps as 2 x 4) computes 128 output channels x an
// 8 x 16 tile of output pixels of one sample. Per 32-channel step it stages
// the nine taps' weights [9][128][32] and the input patch [10][18][32] in
// shared memory (cp.async, rows padded from 32 to 48 bytes, which makes the
// fragment loads free of bank conflicts), then every warp runs 9 x 16 MMAs on
// its 64 x 32 sub-tile. Two CTAs share an SM, so one's loads overlap the
// other's MMAs. The epilogue dequantizes, stages the bf16 tile in shared
// memory and stores rows contiguous along W, masking the ragged right and
// bottom edges and the channels beyond O.
//
// Interface: plain C, loaded with ctypes; launches on the caller's stream
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <stddef.h>
#include <stdint.h>

#include "mma_s8.cuh"

#define AFCM_C8_BM 128        // output channels per CTA
#define AFCM_C8_TH 8          // output rows per CTA
#define AFCM_C8_TW 16         // output columns per CTA
#define AFCM_C8_KC 32         // input channels per step: one MMA's K
#define AFCM_C8_THREADS 256

namespace {

constexpr int BM = AFCM_C8_BM;
constexpr int TH = AFCM_C8_TH;
constexpr int TW = AFCM_C8_TW;
constexpr int BN = TH * TW;                    // 128 output pixels
constexpr int KC = AFCM_C8_KC;
constexpr int ROW = KC + 16;                   // padded bytes per shared row
constexpr int PH = TH + 2;
constexpr int PW = TW + 2;
constexpr int THREADS = AFCM_C8_THREADS;
constexpr int W_BYTES = 9 * BM * ROW;          // 55296
constexpr int X_BYTES = PH * PW * ROW;         // 8640
constexpr int SMEM_BYTES = W_BYTES + X_BYTES;  // 63936
constexpr int OUT_STRIDE = BN + 8;             // bf16 per staged output row

static_assert(BM * OUT_STRIDE * 2 <= SMEM_BYTES, "the output tile reuses the staging memory");
static_assert(BM == 128 && BN == 128 && THREADS == 256, "warp layout: 2 x 4 warps of 64 x 32");

using afcm::cp_async16;
using afcm::cp_async_wait_all;
using afcm::mma_s8;

__global__ void __launch_bounds__(THREADS, 2)
conv3x3_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scale, __nv_bfloat16* __restrict__ y,
                    int O, int Op, int Ip, int Hp, int Wp, int Ho, int Wo,
                    int tiles_w) {
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned char* ws = smem;                   // [9][BM][ROW]
    unsigned char* xs = smem + W_BYTES;         // [PH][PW][ROW]

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;      // the MMA's group and thread in group
    const int wm = warp >> 2, wn = warp & 3;    // warp's 64 channels, 32 pixels
    const int h0 = (blockIdx.x / tiles_w) * TH;
    const int w0 = (blockIdx.x % tiles_w) * TW;
    const int m0 = blockIdx.y * BM;
    const int n = blockIdx.z;

    int acc[4][4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0;

    const int8_t* xn = x + static_cast<size_t>(n) * Hp * Wp * Ip;

    for (int k0 = 0; k0 < Ip; k0 += KC) {
        __syncthreads();                        // the previous step's reads are done
        for (int v = tid; v < 9 * BM * 2; v += THREADS) {
            const int half = v & 1, row = v >> 1;          // row = tap * BM + m
            const int tap = row / BM, m = row % BM;
            const int8_t* src = w + (static_cast<size_t>(tap) * Op + m0 + m) * Ip
                                + k0 + half * 16;
            cp_async16(ws + row * ROW + half * 16, src);
        }
        for (int v = tid; v < PH * PW * 2; v += THREADS) {
            const int half = v & 1, pix = v >> 1;
            const int hh = h0 + pix / PW, ww = w0 + pix % PW;
            unsigned char* dst = xs + pix * ROW + half * 16;
            if (hh < Hp && ww < Wp) {
                cp_async16(dst, xn + (static_cast<size_t>(hh) * Wp + ww) * Ip
                                + k0 + half * 16);
            } else {                             // beyond the image: a masked output's input
                *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
            }
        }
        cp_async_wait_all();
        __syncthreads();

#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
            const int dy = tap / 3, dx = tap % 3;
            uint32_t a[4][4], b[4][2];
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
                afcm::load_frag_a(a[mt], ws + (tap * BM + wm * 64 + mt * 16 + g) * ROW + t * 4,
                                  ROW);
            }
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                const int pr = wn * 2 + (nt >> 1), pc = (nt & 1) * 8 + g;
                afcm::load_frag_b(b[nt], xs + ((pr + dy) * PW + pc + dx) * ROW + t * 4);
            }
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)
#pragma unroll
                for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
        }
    }

    // Epilogue: float(acc) * scale -> bf16 (one multiply, round to nearest
    // even twice, as acc.float() * scale and .to(bfloat16) do), staged so
    // that the stores run along W.
    __syncthreads();
    __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(smem);   // [BM][OUT_STRIDE]
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
            const int m = wm * 64 + mt * 16 + g + hi * 8;
            const int o = m0 + m;
            const float s = o < O ? scale[static_cast<size_t>(n) * O + o] : 0.0f;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                const int nn = wn * 32 + nt * 8 + t * 2;
                const float v0 = __fmul_rn(__int2float_rn(acc[mt][nt][hi * 2 + 0]), s);
                const float v1 = __fmul_rn(__int2float_rn(acc[mt][nt][hi * 2 + 1]), s);
                *reinterpret_cast<__nv_bfloat162*>(os + m * OUT_STRIDE + nn) =
                    __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
            }
        }
    }
    __syncthreads();
    for (int e = tid; e < BM * BN; e += THREADS) {
        const int m = e / BN, nn = e % BN;
        const int o = m0 + m, h = h0 + nn / TW, ww = w0 + nn % TW;
        if (o < O && h < Ho && ww < Wo)
            y[((static_cast<size_t>(n) * O + o) * Ho + h) * Wo + ww] = os[m * OUT_STRIDE + nn];
    }
}

}  // namespace

extern "C" {

// x: int8 [n][hp][wp][ip] (zero halo, ip % 32 == 0); w: int8 [9][op][ip]
// (op % 128 == 0, op >= o); scale: float [n][o]; y: bf16 [n][o][hp-2][wp-2].
int afcm_conv3x3_int8(const void* x, const void* w, const void* scale, void* y,
                      int n, int o, int op, int ip, int hp, int wp, void* stream) {
    if (n < 1 || n > 65535 || o < 1 || op < o || op % AFCM_C8_BM != 0 ||
        ip < AFCM_C8_KC || ip % AFCM_C8_KC != 0 || hp < 3 || wp < 3)
        return static_cast<int>(cudaErrorInvalidValue);
    const int ho = hp - 2, wo = wp - 2;
    const int tiles_w = (wo + TW - 1) / TW;
    const int tiles_h = (ho + TH - 1) / TH;
    if (op / BM > 65535) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        conv3x3_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(tiles_h * tiles_w, op / BM, n);
    conv3x3_int8_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y),
        o, op, ip, hp, wp, ho, wo, tiles_w);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
