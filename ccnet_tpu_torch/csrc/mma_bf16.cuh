// bf16 tensor-core helpers shared by probes.cu, cca_fwd.cu and cca_bwd.cu: mma.sync
// m16n8k16 with f32 accumulators, the ldmatrix loads that build its
// fragments from shared memory, and cp.async copies into shared memory.
//
// Fragment layouts of mma.m16n8k16 (gid = lane / 4, tig = lane % 4):
//   A (16 x 16, row-major): a0 = A[gid][2tig..+1],   a1 = A[gid+8][2tig..+1],
//                           a2 = A[gid][2tig+8..+9], a3 = A[gid+8][2tig+8..+9]
//   B (16 x 8, "col"):      b0 = B[2tig..+1][gid],   b1 = B[2tig+8..+9][gid]
//   C (16 x 8, f32):        c0, c1 = C[gid][2tig..+1], c2, c3 = C[gid+8][2tig..+1]
// The ldmatrix helpers take the shared-memory address of this lane's row of
// the 8 x 8 matrices they load (lanes 8i .. 8i+7 give matrix i's rows, 16
// bytes each, 16-byte aligned); the operand helpers below compute it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two adjacent bf16 values as one 32-bit fragment register
__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// Operand loads from a bf16 shared tile S with row stride `ld` elements (a
// multiple of 8). Each takes the tile's corner (r0, c0).
//
// A = S[r0 .. r0+15][c0 .. c0+15], stored row-major (A[m][k] = S[r0+m][c0+k]).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* S, int ld,
                                       int r0, int c0, int lane) {
  ldmatrix_x4(a, S + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8);
}
// A[m][k] = S[r0+k][c0+m]: the transpose of a stored 16 x 16 tile.
__device__ __forceinline__ void load_a_trans(uint32_t (&a)[4], const __nv_bfloat16* S, int ld,
                                             int r0, int c0, int lane) {
  ldmatrix_x4_trans(a, S + (r0 + (lane & 7) + (lane >> 4) * 8) * ld + c0 +
                           ((lane >> 3) & 1) * 8);
}
// Two B operands (n-tiles n0 and n0 + 8) with B[k][n] = S[n0+n][k0+k]: the
// tile is stored n-major, k contiguous (b[0..1] for n0, b[2..3] for n0 + 8).
__device__ __forceinline__ void load_b2(uint32_t (&b)[4], const __nv_bfloat16* S, int ld,
                                        int n0, int k0, int lane) {
  ldmatrix_x4(b, S + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 + ((lane >> 3) & 1) * 8);
}
// Two B operands with B[k][n] = S[k0+k][n0+n]: stored k-major, n contiguous.
__device__ __forceinline__ void load_b2_trans(uint32_t (&b)[4], const __nv_bfloat16* S, int ld,
                                              int k0, int n0, int lane) {
  ldmatrix_x4_trans(b, S + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
                           (lane >> 4) * 8);
}

// d0 += A b[0..1], d1 += A b[2..3]: the two n-tiles that load_b2* fetched
__device__ __forceinline__ void mma_2(float (&d0)[4], float (&d1)[4], const uint32_t (&a)[4],
                                      const uint32_t (&b)[4]) {
  const uint32_t lo[2] = {b[0], b[1]}, hi[2] = {b[2], b[3]};
  mma_16816(d0, a, lo);
  mma_16816(d1, a, hi);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (the
// source is then not read, but must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

}  // namespace
