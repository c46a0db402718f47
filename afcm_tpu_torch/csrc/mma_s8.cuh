// int8 tensor-core building blocks shared by the int8 kernels
// (conv_int8.cu, probe_int8.cu): cp.async staging, the mma.sync.m16n8k32
// s8 x s8 -> s32 product and the loads of its fragments from shared memory.
//
// Fragment layout of mma.sync.m16n8k32 (lane = 4 * g + t, g = 0..7, t = 0..3):
//   A (16 x 32, row-major):  a0 = A[g][4t..4t+3], a1 = A[g+8][4t..],
//                            a2 = A[g][16+4t..],  a3 = A[g+8][16+4t..]
//   B (32 x 8, column-major): b0 = B[4t..4t+3][g], b1 = B[16+4t..][g]
//   D (16 x 8):              d0, d1 = D[g][2t], D[g][2t+1]; d2, d3 = row g+8
// The lowest byte of a register holds the lowest k.

#pragma once

#include <cuda_runtime.h>

#include <stdint.h>

namespace afcm {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
    const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `Pending` of the committed groups are still in flight.
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    cp_async_commit();
    cp_async_wait<0>();
}

// D += A (16 x 32, row-major s8) * B (32 x 8, column-major s8), s32 accumulate.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment from rows with k contiguous: p = &tile[row g][4t], `row_bytes`
// between rows.
__device__ __forceinline__ void load_frag_a(uint32_t (&a)[4], const unsigned char* p,
                                            int row_bytes) {
    a[0] = lds32(p);                        // row g,     k  0..15
    a[1] = lds32(p + 8 * row_bytes);        // row g + 8, k  0..15
    a[2] = lds32(p + 16);                   // row g,     k 16..31
    a[3] = lds32(p + 8 * row_bytes + 16);   // row g + 8, k 16..31
}

// B fragment from rows with k contiguous (one row per column n of B):
// p = &tile[column g][4t].
__device__ __forceinline__ void load_frag_b(uint32_t (&b)[2], const unsigned char* p) {
    b[0] = lds32(p);                        // column g, k  0..15
    b[1] = lds32(p + 16);                   // column g, k 16..31
}

// B fragments of four n-tiles at once from a tile stored as the caller's
// matrix has it, [32 k][pitch] with n contiguous: the bytes are transposed in
// registers. `col` is the byte column of the thread's four columns (any
// alignment: an unaligned start takes two loads and a funnel shift per row).
// n-tile j's column g is the tile's column col0 + 4g + j, so that a thread's
// accumulators of the four n-tiles are eight neighbouring columns.
__device__ __forceinline__ void load_frag_b_transposed(uint32_t (&b)[4][2],
                                                       const unsigned char* tile,
                                                       int pitch, int col, int t) {
    const int sh = col & 3;
    const unsigned char* base = tile + (col - sh);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        uint32_t w[4];                      // w[r] byte c = B[16 half + 4t + r][c]
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const unsigned char* p = base + (half * 16 + 4 * t + r) * pitch;
            uint32_t lo = lds32(p);
            if (sh) lo = __funnelshift_r(lo, lds32(p + 4), 8 * sh);
            w[r] = lo;
        }
        const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);   // w0.0 w1.0 w0.1 w1.1
        const uint32_t t1 = __byte_perm(w[2], w[3], 0x5140);
        const uint32_t t2 = __byte_perm(w[0], w[1], 0x7362);   // w0.2 w1.2 w0.3 w1.3
        const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
        b[0][half] = __byte_perm(t0, t1, 0x5410);              // column 0, k = 4t..4t+3
        b[1][half] = __byte_perm(t0, t1, 0x7632);
        b[2][half] = __byte_perm(t2, t3, 0x5410);
        b[3][half] = __byte_perm(t2, t3, 0x7632);
    }
}

}  // namespace afcm
