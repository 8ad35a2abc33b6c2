// wgmma on Hopper (sm_90a), shared by K2's kernels (flash_attention.cu),
// the tensor-core decode attention of K1 and K3 (attention_common.cuh) and
// K4's q4c MLP (fused_mlp.cu): shared-memory descriptors for tiles in the
// 128-byte swizzle, the m64n64k16 / m64n128k16 bf16 products with fp32
// accumulators, and K4's m64nNk16 products (N 8 to 128) with A in
// registers and a flag that starts a new sum.
//
// Tile layout. A tile of `rows` rows x D bf16 columns is stored as D / 64
// panels of rows x 64 columns; in a panel row r takes 128 bytes at r * 128,
// and its 16-byte chunk c sits at chunk c ^ (r % 8) (the 128-byte swizzle
// that TMA writes). Panels and tiles start on 1024 bytes. The accumulator
// of m64nNk16 gives warp w of the warpgroup rows 16 w .. 16 w + 15 in the
// m16n8 C layout of mma.sync, n-tile j in d[4 j .. 4 j + 3]; an A operand
// in registers takes each warp's 16 rows in the mma.sync A layout.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_sync.cuh"  // bf16
#include "tma.cuh"       // smem_u32

namespace {

constexpr int PANEL = 64;  // bf16 columns in a 128-byte swizzled row

// Byte offset of (row r, column c) in a swizzled tile of `rows` rows.
__host__ __device__ constexpr int swizzled(int rows, int r, int c) {
  return ((c / PANEL) * rows + r) * 128 + ((((c % PANEL) / 8) ^ (r % 8)) * 16) + (c % 8) * 2;
}

// A wgmma shared-memory descriptor with the 128-byte swizzle: start address,
// leading and stride byte offsets, each in 16-byte units. K-major: the
// stride offset steps 8 rows (1024 bytes); the leading offset is unused.
// MN-major: the leading offset steps from one 64-column panel to the next,
// the stride offset 8 rows of the reduction.
__device__ __forceinline__ uint64_t desc(const bf16* p, uint32_t lead, uint32_t stride) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead >> 4) << 16) | (static_cast<uint64_t>(stride >> 4) << 32) |
         (1ull << 62);
}

// The offset, in the descriptor's 16-byte units, of 16-deep step kk of a
// K-major tile of `rows` rows: panel kk / 4, then 32 bytes a step in it.
__host__ __device__ constexpr uint64_t kstep(int kk, int rows) {
  return static_cast<uint64_t>((kk / 4) * rows * PANEL * 2 + (kk % 4) * 32) >> 4;
}

// The offset of 16-deep step kk of an MN-major tile: 16 rows of 128 bytes.
__host__ __device__ constexpr uint64_t mnstep(int kk) { return static_cast<uint64_t>(kk) * 128; }

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins each accumulator register at this point, so the compiler moves no
// read or write of it across a wgmma wait.
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  // d = A * B (+ d if acc): A 64 x 16 and B 16 x 64 in shared memory, both
  // K-major, at descriptors a + da and b + db (the sums taken inside the asm,
  // so only the base descriptors stay in registers)
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t da, uint64_t b,
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 wa, wb;\nsetp.ne.b32 p, %36, 0;\n"
        "add.s64 wa, %32, %33;\nadd.s64 wb, %34, %35;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, wa, wb, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(da), "l"(b), "l"(db), "r"(acc));
  }
  // d += A * B: A 64 x 16 in registers, B 16 x 64 in shared memory, MN-major,
  // at descriptor b + db
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 wb;\nsetp.ne.b32 p, %38, 0;\nadd.s64 wb, %36, %37;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, wb, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  // d = A * B (+ d if acc): A 64 x 16 and B 16 x 128 in shared memory, both
  // K-major, at descriptors a + da and b + db (the sums taken inside the asm,
  // so only the base descriptors stay in registers)
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t da, uint64_t b,
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 wa, wb;\nsetp.ne.b32 p, %68, 0;\n"
        "add.s64 wa, %64, %65;\nadd.s64 wb, %66, %67;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, wa, wb, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(da), "l"(b), "l"(db), "r"(acc));
  }
  // d += A * B: A 64 x 16 in registers, B 16 x 128 in shared memory, MN-major,
  // at descriptor b + db
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 wb;\nsetp.ne.b32 p, %70, 0;\nadd.s64 wb, %68, %69;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, wb, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "l"(db), "r"(1));
  }
};

// d (+)= A * B: A 64 x 16 in registers (the mma.sync A layout per warp), B
// 16 x N in shared memory, K-major, at descriptor b + db; d is overwritten
// when acc is 0. K4's weight-stationary products (N the rows of x, rounded
// up) and K1's / K3's Q K^T (N 64).
template <int N>
struct WgmmaRK;
template <>
struct WgmmaRK<8> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4], uint64_t b,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 wb;\nsetp.ne.b32 p, %10, 0;\nadd.s64 wb, %8, %9;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3}, {%4, %5, %6, %7}, wb, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "l"(db), "r"(acc));
  }
};
template <>
struct WgmmaRK<16> {
  static __device__ __forceinline__ void run(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 wb;\nsetp.ne.b32 p, %14, 0;\nadd.s64 wb, %12, %13;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, wb, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "l"(db), "r"(acc));
  }
};
template <>
struct WgmmaRK<32> {
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 wb;\nsetp.ne.b32 p, %22, 0;\nadd.s64 wb, %20, %21;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, wb, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "l"(db), "r"(acc));
  }
};
template <>
struct WgmmaRK<64> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 wb;\nsetp.ne.b32 p, %38, 0;\nadd.s64 wb, %36, %37;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, wb, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "l"(db), "r"(acc));
  }
};
template <>
struct WgmmaRK<128> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                             uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 wb;\nsetp.ne.b32 p, %70, 0;\nadd.s64 wb, %68, %69;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, wb, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "l"(db), "r"(acc));
  }
};

}  // namespace
