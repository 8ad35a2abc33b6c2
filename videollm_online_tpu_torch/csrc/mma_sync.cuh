// Warp-level tensor-core helpers for Hopper (sm_90a) shared by the
// tensor-core decode attention of K1 and K3 (attention_common.cuh), the
// mma.sync products of the fused-MLP family (fused_mlp.cu) and K2's wgmma
// kernels (flash_attention.cu: quad reductions, bf16 packing): mma.sync
// m16n8k16 with bf16 operands and fp32 accumulators, its fragment layouts,
// ldmatrix, and cp.async.
//
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4): A (16 x 16,
// row) a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..], a3 =
// A[g+8][2t+8..]; B (16 x 8, col) b0 = B[2t..2t+1][g], b1 = B[2t+8..][g];
// C (16 x 8) c0..c1 = C[g][2t..2t+1], c2..c3 = C[g+8][2t..2t+1]. The C
// layout of two neighbouring n-tiles is the A layout of one k-step, so a
// product's result feeds the next product from registers (c_to_a).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16 x 16, row) * b (16 x 8, col), fp32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Reductions over the 4 lanes that hold one fragment row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The A fragment of rows [r, r + 16), columns [c, c + 16) of a row-major
// bf16 tile with row stride ld.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int ld, int r, int c,
                                       int g, int t) {
  a[0] = ld32(tile + (r + g) * ld + c + 2 * t);
  a[1] = ld32(tile + (r + g + 8) * ld + c + 2 * t);
  a[2] = ld32(tile + (r + g) * ld + c + 2 * t + 8);
  a[3] = ld32(tile + (r + g + 8) * ld + c + 2 * t + 8);
}

// acc += A * B with B (16 x 8) read from rows [n, n + 8) and columns
// [c, c + 16) of a row-major tile: B[kk][nn] = tile[n + nn][c + kk].
__device__ __forceinline__ void mma_rows(float (&acc)[4], const uint32_t (&a)[4],
                                         const bf16* tile, int ld, int n, int c, int g, int t) {
  mma16816(acc, a, ld32(tile + (n + g) * ld + c + 2 * t),
           ld32(tile + (n + g) * ld + c + 2 * t + 8));
}

// The A fragment of one k-step from the C fragments of the two n-tiles
// that cover its 16 columns, rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// The row and column of C-fragment element e of n-tile j.
__device__ __forceinline__ int frag_row(int r0, int e) { return r0 + (e >> 1) * 8; }
__device__ __forceinline__ int frag_col(int c0, int j, int t, int e) {
  return c0 + j * 8 + 2 * t + (e & 1);
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 and receives its part of each in r[0..3]. With
// .trans each matrix arrives transposed: the B fragment of a row-major
// (k, n) tile.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Asynchronous copies global -> shared. With ok false nothing is read and
// the destination is zero-filled (src-size 0), so src only has to be a
// valid address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
