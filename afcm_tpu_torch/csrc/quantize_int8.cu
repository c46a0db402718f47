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
// What bounds them: bytes. Each is a read of the float tensor and a write of
// a quarter to a half as many bytes. Composed of elementwise torch ops they
// took some twenty launches that wrote the float32 integers, a zeroed
// buffer and a permuted copy through device memory, as long as the conv
// itself. Here x is read twice (the maximum, then the quantizing pass; the
// second read finds most of it in L2) and the packed tensor written once:
//
// * amax: partial maxima of |x| per CTA (16-byte loads where the sample's
//   size allows), taken on the bits of |x| as unsigned integers and merged
//   with atomicMax. Non-negative floats order as their bits do, and a NaN's
//   bits lie above infinity's: a maximum has no order, so the result is
//   deterministic, and a NaN anywhere in a sample (or in a weight's output
//   channel) makes its scale NaN, as the plain version's amax does, so the
//   conv's whole sample (channel) comes out NaN and not finite but wrong.
// * quantize: a CTA takes 64 pixels of the padded output plane x 64
//   channels. A thread reads 16 channels of one pixel (lanes on
//   neighbouring pixels, so the NCHW reads coalesce), quantizes, packs 16
//   bytes; the tile is transposed through shared memory and each pixel's 64
//   contiguous channel bytes are written by four lanes. Halo pixels and pad
//   channels are written as zeros by the same pass: no memset.
// * weights: one CTA per output channel: the channel's I x 9 floats are
//   read once, coalesced, into shared memory with the block maximum on the
//   way, then quantized from there (stride 9: no bank conflicts) and
//   written as runs of 16 bytes into the tiled layout.
//
// Interface: plain C, loaded with ctypes; launches on the caller's stream
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <stddef.h>
#include <stdint.h>

#define AFCM_Q8_THREADS 256
#define AFCM_Q8_PIX 64        // pixels per CTA of the activation quantizer
#define AFCM_Q8_CH 64         // channels per CTA
#define AFCM_Q8_PITCH 80      // bytes per staged pixel: 16-byte stores without bank conflicts

namespace {

constexpr int THREADS = AFCM_Q8_THREADS;
constexpr int PIX = AFCM_Q8_PIX;
constexpr int CH = AFCM_Q8_CH;
constexpr int PITCH = AFCM_Q8_PITCH;

static_assert(THREADS == PIX * (CH / 16), "a thread packs 16 channels of one pixel");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// clip(rint(v / scale), -127, 127): IEEE division, round half to even. Under
// a NaN scale every quotient is NaN and quantizes to 0; the scale carries the
// NaN to the conv's output.
__device__ __forceinline__ int quantize(float v, float scale) {
    const float r = rintf(__fdiv_rn(v, scale));
    return r != r ? 0 : static_cast<int>(fminf(fmaxf(r, -127.f), 127.f));
}

// The bits of |v|: they order as the non-negative floats do, NaN above all.
__device__ __forceinline__ unsigned abs_bits(float v) { return __float_as_uint(v) & 0x7fffffffu; }

// max(amax, floor) / 127 that keeps a NaN amax (fmaxf would drop it).
__device__ __forceinline__ float scale_of(unsigned amax_bits, float floor) {
    const float a = __uint_as_float(amax_bits);
    return __fdiv_rn(a < floor ? floor : a, 127.0f);
}

__device__ __forceinline__ unsigned block_max(unsigned m) {
    __shared__ unsigned s_part[THREADS / 32];
    __shared__ unsigned s_all;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, d));
    if ((threadIdx.x & 31) == 0) s_part[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned all = s_part[0];
        for (int i = 1; i < THREADS / 32; ++i) all = max(all, s_part[i]);
        s_all = all;
    }
    __syncthreads();
    return s_all;
}

template <typename T, bool Vec>
__global__ void __launch_bounds__(THREADS)
amax_kernel(const T* __restrict__ x, unsigned* __restrict__ amax, long long count) {
    const T* xs = x + static_cast<long long>(blockIdx.y) * count;
    const long long stride = static_cast<long long>(gridDim.x) * THREADS;
    const long long first = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
    unsigned m = 0u;
    if (Vec) {
        constexpr int PER = 16 / sizeof(T);
        const uint4* xv = reinterpret_cast<const uint4*>(xs);
        for (long long e = first; e < count / PER; e += stride) {
            const uint4 v = xv[e];
            const T* t = reinterpret_cast<const T*>(&v);
#pragma unroll
            for (int j = 0; j < PER; ++j) m = max(m, abs_bits(to_f32(t[j])));
        }
    } else {
        for (long long e = first; e < count; e += stride) m = max(m, abs_bits(to_f32(xs[e])));
    }
    m = block_max(m);
    if (threadIdx.x == 0) atomicMax(amax + blockIdx.y, m);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
quantize_activations_kernel(const T* __restrict__ x, const unsigned* __restrict__ amax,
                            float* __restrict__ x_scale, int8_t* __restrict__ out,
                            int I, int Ip, int H, int W, int p) {
    __shared__ __align__(16) unsigned char tile[PIX * PITCH];
    const int tid = threadIdx.x;
    const int n = blockIdx.z, c0 = blockIdx.y * CH, pix0 = blockIdx.x * PIX;
    const int Wp = W + 2 * p, plane = (H + 2 * p) * Wp;
    const float scale = scale_of(amax[n], 1e-8f);
    if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) x_scale[n] = scale;

    {   // quantize 16 channels of one pixel of the padded plane
        const int pix = tid % PIX, cg = tid / PIX;
        const int op = pix0 + pix;
        uint32_t words[4] = {0u, 0u, 0u, 0u};
        if (op < plane) {
            const int h = op / Wp - p, ww = op % Wp - p;
            if (h >= 0 && h < H && ww >= 0 && ww < W) {
                const T* src = x + ((static_cast<size_t>(n) * I + c0 + cg * 16) * H + h) * W + ww;
                const size_t cstride = static_cast<size_t>(H) * W;
                float v[16];
#pragma unroll
                for (int j = 0; j < 16; ++j)
                    v[j] = (c0 + cg * 16 + j < I) ? to_f32(src[j * cstride]) : 0.f;
#pragma unroll
                for (int j = 0; j < 16; ++j)
                    words[j >> 2] |= static_cast<uint32_t>(quantize(v[j], scale) & 0xff)
                                     << (8 * (j & 3));
            }
        }
        *reinterpret_cast<uint4*>(tile + pix * PITCH + cg * 16) =
            make_uint4(words[0], words[1], words[2], words[3]);
    }
    __syncthreads();
    {   // four lanes write one pixel's 64 channel bytes
        const int pix = tid >> 2, part = tid & 3;
        const int op = pix0 + pix, c = c0 + part * 16;
        if (op < plane && c < Ip)
            *reinterpret_cast<uint4*>(out + (static_cast<size_t>(n) * plane + op) * Ip + c) =
                *reinterpret_cast<const uint4*>(tile + pix * PITCH + part * 16);
    }
}

// Byte offset of (tap, output channel o, input channel i) in the tiled
// weights; kb_count = I' / 32.
__device__ __forceinline__ size_t tiled_offset(int tap, int o, int i, int kb_count) {
    const int mb = o >> 6, m = o & 63, kb = i >> 5, kc = (i >> 4) & 1, b = i & 15;
    return ((((static_cast<size_t>(mb) * kb_count + kb) * 9 + tap) * 2 + kc) * 64 + m) * 16 + b;
}

// `staged`: the channel's floats fit the dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(THREADS)
quantize_weights_kernel(const T* __restrict__ w, float* __restrict__ w_scale,
                        int8_t* __restrict__ out, int O, int I, int Ip, int staged) {
    extern __shared__ float s_row[];            // [I * 9] when staged
    const int o = blockIdx.x, tid = threadIdx.x;
    const int kb_count = Ip >> 5;
    if (o >= O) {                               // the channel pad
        for (int i = tid; i < Ip; i += THREADS)
#pragma unroll
            for (int tap = 0; tap < 9; ++tap) out[tiled_offset(tap, o, i, kb_count)] = 0;
        return;
    }
    const T* row = w + static_cast<size_t>(o) * I * 9;
    unsigned m = 0u;
    for (int e = tid; e < I * 9; e += THREADS) {
        const float v = to_f32(row[e]);
        if (staged) s_row[e] = v;
        m = max(m, abs_bits(v));
    }
    const float scale = scale_of(block_max(m), 1e-12f);         // syncs the block
    if (tid == 0) w_scale[o] = scale;
    for (int i = tid; i < Ip; i += THREADS) {
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
            int q = 0;
            if (i < I) q = quantize(staged ? s_row[i * 9 + tap] : to_f32(row[i * 9 + tap]), scale);
            out[tiled_offset(tap, o, i, kb_count)] = static_cast<int8_t>(q);
        }
    }
}

template <typename T>
int launch_weights(const T* w, float* w_scale, int8_t* out, int o, int op, int i, int ip,
                   cudaStream_t stream) {
    const size_t row_bytes = sizeof(float) * i * 9;
    const int staged = row_bytes <= 40 * 1024;
    quantize_weights_kernel<T><<<op, THREADS, staged ? row_bytes : 0, stream>>>(
        w, w_scale, out, o, i, ip, staged);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_activations(const T* x, unsigned* amax, float* x_scale, int8_t* out, int n, int i,
                       int ip, int h, int w, int p, cudaStream_t stream) {
    cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned) * n, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long count = static_cast<long long>(i) * h * w;
    constexpr int PER = 16 / sizeof(T);
    const bool vec = count % PER == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    long long blocks = (count / (vec ? PER : 1) + THREADS * 8 - 1) / (THREADS * 8);
    blocks = blocks < 1 ? 1 : (blocks > 256 ? 256 : blocks);
    dim3 grid_a(static_cast<unsigned>(blocks), n);
    if (vec) amax_kernel<T, true><<<grid_a, THREADS, 0, stream>>>(x, amax, count);
    else amax_kernel<T, false><<<grid_a, THREADS, 0, stream>>>(x, amax, count);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int plane = (h + 2 * p) * (w + 2 * p);
    dim3 grid_q((plane + PIX - 1) / PIX, (ip + CH - 1) / CH, n);
    quantize_activations_kernel<T><<<grid_q, THREADS, 0, stream>>>(
        x, amax, x_scale, out, i, ip, h, w, p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x: [n][i][h][w] contiguous; amax:
// scratch of n 32-bit words; x_scale: float [n]; out: int8
// [n][h+2p][w+2p][ip], ip % 32 == 0, ip >= i. Every byte of out is written.
int afcm_quantize_activations(const void* x, void* amax, void* x_scale, void* out, int dtype,
                              int n, int i, int ip, int h, int w, int p, void* stream) {
    if (n < 1 || n > 65535 || i < 1 || ip < i || ip % 32 != 0 || h < 1 || w < 1 || p < 0 ||
        (ip + CH - 1) / CH > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    unsigned* am = static_cast<unsigned*>(amax);
    float* xs = static_cast<float*>(x_scale);
    int8_t* o8 = static_cast<int8_t*>(out);
    if (dtype == 0)
        return launch_activations(static_cast<const float*>(x), am, xs, o8, n, i, ip, h, w, p, st);
    if (dtype == 1)
        return launch_activations(static_cast<const __nv_bfloat16*>(x), am, xs, o8, n, i, ip, h,
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

}  // extern "C"
