// K4, K5, K6, K7: the SwiGLU MLP and the int4 matmul over weight-only
// quantized weights, for Hopper (sm_90a).
//
// Replaces the TPU kernels of videollm_online_tpu/ops/fused_mlp.py:
//   K4 fused_mlp_int4c (_kernel_int4c)        column-packed int4 "q4c"
//   K5 matmul_int4c    (_kernel_matmul_int4c) x @ q4c -> fp32 (the lm_head)
//   K6 fused_mlp_int8  (_kernel)              int8, per-column scales
//   K7 fused_mlp_int4  (_kernel_int4)         row-packed int4 "q4p"
//
// What they compute. x (B <= 128, K) in bf16 times a (K, N) matrix of small
// integers stored packed, accumulated in fp32. For int4 the fp32 scale of
// each group of `group` reduction rows multiplies that group's partial sum
// and the groups are then added in fp32; for int8 the column's scale
// multiplies the whole sum. The MLP is two such products with
// h = silu(gate) * up between them, taken in fp32 and rounded to bf16.
// Byte layouts (models/quant.py):
//   q4c (K, N/2): byte (k, j) = 16 * q[k, j + N/2] + (q[k, j] + 8)
//   q4p (K/2, N): byte (i, n) = q[i, n] (low nibble), q[i + K/2, n] (high)
//   q8  (K, N):   byte (k, n) = q[k, n]
// Every byte value is decoded right: lo = (byte & 15) - 8 and hi = byte >> 4
// (arithmetic) for q4c, two sign-extended nibbles for q4p.
//
// Bound. A product of B rows does 2 * B operations per int4 weight and
// int4 packs two weights a byte, so 4 * B operations per weight byte (2 * B
// for int8). The card needs ~295 bf16 operations a byte before the tensor
// cores and not HBM are the limit: int4 is bound by the bytes of the
// weights, each read once (94 MB for an 8B layer's MLP, 279 MB for the
// head), up to about 74 rows and by operations above (the 91-row chunk
// ingest and 128-row prompts); int8 is bound by bytes up to 128 rows.
//
// K4 (q4c::, below): the MLP's two products on wgmma, weight-stationary,
// with x as the B operand (N = B rounded up to 8 .. 128) and the decoded
// weights as A in registers, so each weight byte is decoded once whatever
// B is; persistent CTAs stream (column tile, reduction split) work units
// through an 8-slot TMA ring on mbarriers (two warpgroups, thread 0 also
// issuing the loads), write each unit's fp32 partial result to its own slot, and
// the merge kernels below add the splits in a fixed order, SwiGLU between
// the products. Byte rows that are not 16-byte aligned (D or F not a
// multiple of 32; no model has one) take the mma.sync design below.
//
// K5, K6 and K7 (wo::, below): one streaming weight-only core on mma.sync,
// a template over the three layouts. K7 takes it where half its reduction
// dim is a multiple of 16 and of the scale group (every model at group
// 128), and the group is a multiple of 16 that divides a 64-row slot or is
// a multiple of one.
//
// K4, K5, K6 at shapes whose byte rows are not 16-byte aligned (no model
// has one), and K7 at shapes the core does not take (a matrix shorter than
// its group, whose one group spans both halves): one family,
// qgemm_partial_kernel, computes
// x @ W for one tile of byte columns and one range of reduction rows, with
// the layout as a template parameter that says how a byte becomes values.
// The TPU kernels walk the MLP's inner dimension F on a sequential grid axis
// and carry the (B, D) sum in VMEM. Here the MLP is two launches with h kept
// as a (B, F) bf16 workspace between them (h is rounded to bf16 anyway, so
// nothing is lost), and each product's reduction rows are cut across CTAs so
// that the card's 132 SMs all stream weights: every CTA writes its fp32
// partial result to a workspace and a small merge kernel adds the splits in
// a fixed order (no floating-point atomics: the sum's order never changes
// from run to run) and applies the epilogue (SwiGLU to bf16, or the plain
// sum).
//
// A CTA stages 64 reduction rows at a time: the weight bytes and the x
// columns go from device memory to registers with 16-byte loads (the next
// tile's loads are in flight while the current tile is computed on) and then
// to shared memory. The products run on mma.sync m16n8k16 with bf16
// operands and fp32 accumulators; all rows share each weight tile, so the
// weights are read once whatever B is. Each thread reads a 4 x 4 block of
// weight bytes (4 reduction rows, 4 byte columns) as four 32-bit words,
// which serves 8 n-tiles (the low and the high nibble of 4 byte columns):
// the reduction rows of a k-step are taken in the order 4t .. 4t + 3 per
// thread and the 8 columns of n-tile i are the byte columns 4n + i, both
// free choices since x's fragments follow the same row order and the
// results are written back to their true columns. Nibbles become bf16 with
// integer masks and one bf16 subtraction: 0x4300 | v is the bf16 of 128 + v
// for v in [0, 15], and every nibble is first put into the form "value + 8"
// by one xor per word.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sync.cuh"  // bf16, mma16816
#include "tma.cuh"       // mbarriers, TMA copies, the tensor-map encoder
#include "wgmma.cuh"     // wgmma with A in registers, descriptors, the 128-byte swizzle

namespace {

constexpr int KT = 64;    // reduction rows per staged tile
constexpr int XPAD = 16;  // bf16 of padding per staged x row
constexpr int WPAD = 8;   // bytes of padding per staged weight row

constexpr int Q4C = 0;
constexpr int Q4P = 1;
constexpr int Q8 = 2;

struct GemmArgs {
  const bf16* x;       // (B, K), row-major
  const int8_t* w[2];  // byte matrices (rows, cbytes)
  const float* s[2];   // int4: group scales (K / group, N); int8: unused here
  float* partial;      // (mats, splits, B, N) fp32
  int B, K, N;
  int group;           // reduction rows per scale group
  int rows;            // byte-matrix rows: K, or K / 2 for q4p
  int cbytes;          // byte-matrix columns: N / 2 for q4c, else N
  int rows_per_split;  // byte-matrix rows per split, a multiple of 16
  int vec_ok;          // every byte row starts 16-byte aligned
};

// Byte i of a and byte i of b, each a nibble value v + 8 in [0, 15], as the
// bf16 pair (v_a, v_b): a in the low half (i is known after unrolling).
__device__ __forceinline__ uint32_t nibbles(uint32_t a, uint32_t b, int i) {
  const uint32_t sel = i | (i << 4) | ((4 + i) << 8) | (i << 12);
  uint32_t v = (__byte_perm(a, b, sel) & 0x000F000Fu) | 0x43004300u;  // 128 + (v + 8)
  const uint32_t bias = 0x43084308u;                                  // 136
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v),
                             *reinterpret_cast<const __nv_bfloat162*>(&bias));
  return *reinterpret_cast<uint32_t*>(&r);
}

// Byte I of a and of b as signed 8-bit integers, as a bf16 pair (exact).
template <int I>
__device__ __forceinline__ uint32_t int8_pair(uint32_t a, uint32_t b) {
  const int va = static_cast<int>(a << (24 - 8 * I)) >> 24;
  const int vb = static_cast<int>(b << (24 - 8 * I)) >> 24;
  __nv_bfloat162 r = __floats2bfloat162_rn(static_cast<float>(va), static_cast<float>(vb));
  return *reinterpret_cast<uint32_t*>(&r);
}

// 16 bytes of byte row `row` from byte column `col`; zero past the range.
__device__ __forceinline__ uint4 load_w_chunk(const int8_t* __restrict__ w, int row, int col,
                                              int row_end, int cbytes, int vec_ok) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (row >= row_end || col >= cbytes) return v;
  const int8_t* p = w + static_cast<size_t>(row) * cbytes + col;
  if (vec_ok && col + 16 <= cbytes) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (col + i < cbytes) word[i / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(p[i])) << (8 * (i % 4));
  return make_uint4(word[0], word[1], word[2], word[3]);
}

// One CTA's partial product. grid (column tiles, splits, matrices). MT
// m-tiles of 16 rows per warp, WM warps over the rows, WN warps over the
// byte columns (32 each).
template <int LAYOUT, int MT, int WM, int WN>
__device__ __forceinline__ void qgemm_partial(const GemmArgs& a) {
  constexpr int THREADS = WM * WN * 32;
  constexpr int ROWS = MT * WM * 16;          // staged x rows
  constexpr int CB = WN * 32;                 // byte columns per CTA
  constexpr int XS = KT + XPAD;               // x row stride, bf16
  constexpr int WS = CB + WPAD;               // weight row stride, bytes
  constexpr int NX = LAYOUT == Q4P ? 2 : 1;   // x tiles: one per half of K
  constexpr int NT = LAYOUT == Q8 ? 4 : 8;    // n-tiles a warp computes
  constexpr int NA = LAYOUT == Q4C ? 8 : 4;   // n-tiles a warp writes
  constexpr bool GROUPS = LAYOUT != Q8;
  constexpr int WCH = KT * CB / 16 / THREADS;   // weight chunks per thread
  constexpr int XCH = ROWS * KT / 8 / THREADS;  // x chunks per thread per tile
  static_assert(WCH >= 1 && KT * CB / 16 % THREADS == 0, "weight tile");
  static_assert(XCH >= 1 && ROWS * KT / 8 % THREADS == 0, "x tile");

  __shared__ __align__(16) bf16 sx[NX][ROWS * XS];
  __shared__ __align__(16) uint8_t sw[KT * WS];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / WN;
  const int wn = warp % WN;
  const int gq = lane >> 2;
  const int t = lane & 3;
  const int mat = blockIdx.z;
  const int8_t* __restrict__ w = a.w[mat];
  const float* __restrict__ sc = a.s[mat];
  const int col0 = blockIdx.x * CB;
  const int r_begin = blockIdx.y * a.rows_per_split;
  const int r_end = min(a.rows, r_begin + a.rows_per_split);

  uint4 wreg[WCH];
  uint4 xreg[NX][XCH];
  auto prefetch = [&](int r0) {
#pragma unroll
    for (int k = 0; k < WCH; ++k) {
      const int idx = threadIdx.x + k * THREADS;
      const int row = idx / (CB / 16);
      const int ch = idx % (CB / 16);
      wreg[k] = load_w_chunk(w, r0 + row, col0 + ch * 16, r_end, a.cbytes, a.vec_ok);
    }
#pragma unroll
    for (int h = 0; h < NX; ++h) {
#pragma unroll
      for (int k = 0; k < XCH; ++k) {
        const int idx = threadIdx.x + k * THREADS;
        const int row = idx / (KT / 8);
        const int kk = r0 + (idx % (KT / 8)) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (row < a.B && kk < r_end)
          v = *reinterpret_cast<const uint4*>(a.x + static_cast<size_t>(row) * a.K +
                                              h * a.rows + kk);
        xreg[h][k] = v;
      }
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int k = 0; k < WCH; ++k) {
      const int idx = threadIdx.x + k * THREADS;
      uint8_t* dst = sw + (idx / (CB / 16)) * WS + (idx % (CB / 16)) * 16;
      *reinterpret_cast<uint2*>(dst) = make_uint2(wreg[k].x, wreg[k].y);
      *reinterpret_cast<uint2*>(dst + 8) = make_uint2(wreg[k].z, wreg[k].w);
    }
#pragma unroll
    for (int h = 0; h < NX; ++h) {
#pragma unroll
      for (int k = 0; k < XCH; ++k) {
        const int idx = threadIdx.x + k * THREADS;
        *reinterpret_cast<uint4*>(&sx[h][(idx / (KT / 8)) * XS + (idx % (KT / 8)) * 8]) =
            xreg[h][k];
      }
    }
  };

  // c: the running group's sums (n-tiles 0-3 from low nibbles, 4-7 from
  // high); acc: the scaled sums of the groups done.
  float c[MT][NT][4];
  float acc[MT][NA][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[m][i][e] = 0.f;
#pragma unroll
    for (int i = 0; i < NA; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][i][e] = 0.f;
  }

  // This thread's two byte columns of n-tile i: bcol + i and bcol + 4 + i.
  const int bcol = col0 + wn * 32 + 8 * t;

  // acc += c * scale[group] for the n-tiles of one nibble half, c = 0.
  auto flush = [&](auto half_c, int group) {
    constexpr int half = decltype(half_c)::value;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ca = bcol + i;
      const int cb = ca + 4;
      float sa = 1.f, sb = 1.f;
      if constexpr (GROUPS) {
        const int shift = (LAYOUT == Q4C && half) ? a.N / 2 : 0;
        const float* srow = sc + static_cast<size_t>(group) * a.N + shift;
        sa = ca < a.cbytes ? srow[ca] : 0.f;
        sb = cb < a.cbytes ? srow[cb] : 0.f;
      }
      const int ci = half * 4 + i;
      const int ai = LAYOUT == Q4C ? ci : i;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        acc[m][ai][0] = fmaf(c[m][ci][0], sa, acc[m][ai][0]);
        acc[m][ai][1] = fmaf(c[m][ci][1], sb, acc[m][ai][1]);
        acc[m][ai][2] = fmaf(c[m][ci][2], sa, acc[m][ai][2]);
        acc[m][ai][3] = fmaf(c[m][ci][3], sb, acc[m][ai][3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) c[m][ci][e] = 0.f;
      }
    }
  };

  constexpr std::integral_constant<int, 0> LO{};
  constexpr std::integral_constant<int, 1> HI{};
  int cur_lo = -1, cur_hi = -1;  // the group c's halves are summing
  if (r_begin < r_end) prefetch(r_begin);
  for (int r0 = r_begin; r0 < r_end; r0 += KT) {
    __syncthreads();  // every warp is done with the previous tile
    stage();
    __syncthreads();
    if (r0 + KT < r_end) prefetch(r0 + KT);  // in flight during the compute
    const int steps = min(KT, r_end - r0) / 16;
    for (int s = 0; s < steps; ++s) {
      if constexpr (GROUPS) {
        const int g_lo = (r0 + 16 * s) / a.group;
        const int g_hi = LAYOUT == Q4P ? (a.rows + r0 + 16 * s) / a.group : g_lo;
        if (g_lo != cur_lo) {
          if (cur_lo >= 0) flush(LO, cur_lo);
          cur_lo = g_lo;
        }
        if (g_hi != cur_hi) {
          if (cur_hi >= 0) flush(HI, cur_hi);
          cur_hi = g_hi;
        }
      }
      // x fragments: this thread's 4 reduction rows are 16 s + 4 t + (0..3)
      uint32_t af[NX][MT][4];
#pragma unroll
      for (int h = 0; h < NX; ++h) {
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const bf16* p = &sx[h][((wm * MT + m) * 16 + gq) * XS + 16 * s + 4 * t];
          const uint2 v0 = *reinterpret_cast<const uint2*>(p);
          const uint2 v1 = *reinterpret_cast<const uint2*>(p + 8 * XS);
          af[h][m][0] = v0.x;
          af[h][m][1] = v1.x;
          af[h][m][2] = v0.y;
          af[h][m][3] = v1.y;
        }
      }
      // the 4 x 4 block of weight bytes: rows 16 s + 4 t + r, byte columns
      // wn * 32 + 4 gq + (0..3)
      uint32_t wd[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        wd[r] = *reinterpret_cast<const uint32_t*>(sw + (16 * s + 4 * t + r) * WS + wn * 32 +
                                                   4 * gq);
      uint32_t b[NT][2];
      if constexpr (LAYOUT == Q8) {
#define Q8_TILE(I)                          \
  b[I][0] = int8_pair<I>(wd[0], wd[1]);     \
  b[I][1] = int8_pair<I>(wd[2], wd[3]);
        Q8_TILE(0) Q8_TILE(1) Q8_TILE(2) Q8_TILE(3)
#undef Q8_TILE
      } else {
        // every nibble to the form value + 8: q4c's low nibble has it, its
        // high nibble and both of q4p's are two's complement
        constexpr uint32_t flip = LAYOUT == Q4C ? 0x80808080u : 0x88888888u;
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint32_t v = wd[r] ^ flip;
          lo[r] = v & 0x0F0F0F0Fu;
          hi[r] = (v >> 4) & 0x0F0F0F0Fu;
        }
#define Q4_TILE(I)                                         \
  b[I][0] = nibbles(lo[0], lo[1], I);                      \
  b[I][1] = nibbles(lo[2], lo[3], I);                      \
  b[(NT - 4) + I][0] = nibbles(hi[0], hi[1], I);           \
  b[(NT - 4) + I][1] = nibbles(hi[2], hi[3], I);
        Q4_TILE(0) Q4_TILE(1) Q4_TILE(2) Q4_TILE(3)
#undef Q4_TILE
      }
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        // q4p: high nibbles are the rows of K's second half
        const int h = (LAYOUT == Q4P && i >= 4) ? NX - 1 : 0;
#pragma unroll
        for (int m = 0; m < MT; ++m) mma16816(c[m][i], af[h][m], b[i][0], b[i][1]);
      }
    }
  }
  if constexpr (GROUPS) {
    if (cur_lo >= 0) flush(LO, cur_lo);
    if (cur_hi >= 0) flush(HI, cur_hi);
  } else {
    flush(LO, 0);
  }

  float* __restrict__ out =
      a.partial + (static_cast<size_t>(mat) * gridDim.y + blockIdx.y) * a.B * a.N;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int ra = (wm * MT + m) * 16 + gq;
    const int rb = ra + 8;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int shift = (LAYOUT == Q4C && i >= 4) ? a.N / 2 : 0;
      const int ca = bcol + (i & 3);
      const int cb = ca + 4;
      if (ra < a.B) {
        if (ca < a.cbytes) out[static_cast<size_t>(ra) * a.N + shift + ca] = acc[m][i][0];
        if (cb < a.cbytes) out[static_cast<size_t>(ra) * a.N + shift + cb] = acc[m][i][1];
      }
      if (rb < a.B) {
        if (ca < a.cbytes) out[static_cast<size_t>(rb) * a.N + shift + ca] = acc[m][i][2];
        if (cb < a.cbytes) out[static_cast<size_t>(rb) * a.N + shift + cb] = acc[m][i][3];
      }
    }
  }
}

// The MLPs' products (K4, K6, K7) and the int4 matmul (K5) are the same
// code under two kernel names, so that a profile tells them apart.
template <int LAYOUT, int MT, int WM, int WN>
__global__ void __launch_bounds__(WM * WN * 32) fused_mlp_gemm_kernel(const GemmArgs a) {
  qgemm_partial<LAYOUT, MT, WM, WN>(a);
}

template <int MT, int WM, int WN>
__global__ void __launch_bounds__(WM * WN * 32) matmul_int4c_gemm_kernel(const GemmArgs a) {
  qgemm_partial<Q4C, MT, WM, WN>(a);
}

// h = bf16(silu(gate) * up): gate and up are the sums of the splits'
// partial results (matrix 0 and 1 of `partial`), in split order, times the
// column's scale where there is one (int8).
__global__ void swiglu_merge_kernel(const float* __restrict__ partial,
                                    const float* __restrict__ sg, const float* __restrict__ su,
                                    bf16* __restrict__ h, int splits, int B, int N) {
  const size_t total = static_cast<size_t>(B) * N;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float g = 0.f, u = 0.f;
  for (int s = 0; s < splits; ++s) {
    g += partial[s * total + idx];
    u += partial[(static_cast<size_t>(splits) + s) * total + idx];
  }
  if (sg != nullptr) {
    const int n = static_cast<int>(idx % N);
    g *= sg[n];
    u *= su[n];
  }
  h[idx] = __float2bfloat16((g * (1.f / (1.f + expf(-g)))) * u);
}

// out = the sum of the splits' partial results, in split order, times the
// column's scale where there is one (int8).
__device__ __forceinline__ void sum_merge(const float* __restrict__ partial,
                                          const float* __restrict__ scale,
                                          float* __restrict__ out, int splits, int B, int N) {
  const size_t total = static_cast<size_t>(B) * N;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += partial[s * total + idx];
  if (scale != nullptr) v *= scale[idx % N];
  out[idx] = v;
}

__global__ void fused_mlp_down_merge_kernel(const float* __restrict__ partial,
                                            const float* __restrict__ scale,
                                            float* __restrict__ out, int splits, int B, int N) {
  sum_merge(partial, scale, out, splits, B, N);
}

__global__ void matmul_int4c_merge_kernel(const float* __restrict__ partial,
                                          float* __restrict__ out, int splits, int B, int N) {
  sum_merge(partial, nullptr, out, splits, B, N);
}

// LAYOUT < 0: the int4 matmul's kernel name (its layout is q4c).
template <int LAYOUT, int MT, int WM, int WN>
cudaError_t launch_config(const GemmArgs& a, int mats, int splits, cudaStream_t stream) {
  const dim3 grid((a.cbytes + WN * 32 - 1) / (WN * 32), splits, mats);
  if constexpr (LAYOUT < 0)
    matmul_int4c_gemm_kernel<MT, WM, WN><<<grid, WM * WN * 32, 0, stream>>>(a);
  else
    fused_mlp_gemm_kernel<LAYOUT, MT, WM, WN><<<grid, WM * WN * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

// The row configuration for B rows: more m-tiles per warp and more warps
// over the rows as B grows, narrower column tiles to keep the registers.
template <int LAYOUT>
cudaError_t launch_rows(const GemmArgs& a, int mats, int splits, cudaStream_t stream) {
  if (a.B <= 16) return launch_config<LAYOUT, 1, 1, 4>(a, mats, splits, stream);
  if (a.B <= 32) return launch_config<LAYOUT, 2, 1, 4>(a, mats, splits, stream);
  if (a.B <= 64) return launch_config<LAYOUT, 2, 2, 2>(a, mats, splits, stream);
  if (a.B <= 128) return launch_config<LAYOUT, 2, 4, 2>(a, mats, splits, stream);
  return cudaErrorInvalidValue;
}

// One product's partial results: x (B, K) @ the `mats` matrices w (K, N);
// matmul: under the int4 matmul's kernel name (layout q4c).
cudaError_t launch_gemm(bool matmul, int layout, const void* x, const void* w0, const void* s0, const void* w1,
                        const void* s1, void* partial, int B, int K, int N, int group, int mats,
                        int splits, int rows_per_split, cudaStream_t stream) {
  GemmArgs a;
  a.x = static_cast<const bf16*>(x);
  a.w[0] = static_cast<const int8_t*>(w0);
  a.w[1] = static_cast<const int8_t*>(w1);
  a.s[0] = static_cast<const float*>(s0);
  a.s[1] = static_cast<const float*>(s1);
  a.partial = static_cast<float*>(partial);
  a.B = B;
  a.K = K;
  a.N = N;
  a.group = group;
  a.rows = layout == Q4P ? K / 2 : K;
  a.cbytes = layout == Q4C ? N / 2 : N;
  a.rows_per_split = rows_per_split;
  a.vec_ok = a.cbytes % 16 == 0 && reinterpret_cast<uintptr_t>(w0) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(w1) % 16 == 0;
  if (B < 1 || K % 16 || N % 2 || group < 16 || group % 16 || K % group || a.rows % 16 ||
      rows_per_split < 16 || rows_per_split % 16 || splits < 1 ||
      static_cast<long long>(splits) * rows_per_split < a.rows ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return cudaErrorInvalidValue;
  if (matmul) return layout == Q4C ? launch_rows<-1>(a, mats, splits, stream) : cudaErrorInvalidValue;
  switch (layout) {
    case Q4C: return launch_rows<Q4C>(a, mats, splits, stream);
    case Q4P: return launch_rows<Q4P>(a, mats, splits, stream);
    case Q8: return launch_rows<Q8>(a, mats, splits, stream);
    default: return cudaErrorInvalidValue;
  }
}

constexpr int MERGE_THREADS = 256;

int merge_blocks(int B, int N) {
  return static_cast<int>((static_cast<size_t>(B) * N + MERGE_THREADS - 1) / MERGE_THREADS);
}

// ---------------------------------------------------------------------------
// K4 for Hopper: the q4c products of the MLP on wgmma, weight-stationary
// ("swap AB"): out^T (n x B) = W^T (n x K) x^T (K x B). The decoded weights
// are the 64-row A operand, in registers; x is the B operand, N = B rounded
// up to 8, 16, 32, 64 or 128, in shared memory. One warpgroup serves 1 to
// 128 rows and decodes every weight byte once.
//
// Persistent CTAs (at most one an SM) walk the product's work units, (matrix,
// column tile of BC byte columns, split of `per` reduction rows), unit u at
// CTA u % grid, in a fixed order. Thread 0 streams each unit's slots
// through a ring of STAGES mbarrier-guarded slots by TMA: KT = 64 reduction
// rows of the weight tile (bytes as stored, no swizzle) and the
// same 64 columns of x (N rows, the 128-byte swizzle; rows past B and
// columns past K read TMA's zero fill). Two warpgroups each own BC / 2 byte
// columns of the tile (a ninth, loading warp would cap ptxas at 168
// registers, as in K2b, and the N 32 accumulators would spill). Per 16-deep step a thread reads, for
// reduction rows 2t, 2t + 1, 2t + 8 and 2t + 9, the MT bytes at its byte
// columns; byte i gives m-tile i's A rows g (the low nibble: output column
// c) and g + 8 (the high nibble: column c + n / 2), decoded to bf16 by the
// masks and one subtraction of `nibbles`. Each scale group's sum runs in
// the wgmma accumulator c (the group's first product overwrites it) and is
// added, times the group's scale, into acc in fp32; each unit writes acc to
// its own slot of the partial workspace, which the merge kernels add in a
// fixed order: equal bits on every run, no atomics. MT (64-column m-tiles a
// warpgroup) shrinks as N grows so c and acc (MT * N fp32) stay at 128
// registers or fewer.
namespace q4c {

constexpr int KT = 64;                            // reduction rows a slot
constexpr int STAGES = 8;                         // slots in the ring
constexpr int LAG = 4;                            // see the loader below
constexpr int CONSUMERS = 2;                      // warpgroups
constexpr int THREADS = CONSUMERS * 128;          // thread 0 also loads

template <int N>
struct Cfg {
  static constexpr int MT = N >= 128 ? 1 : N >= 64 ? 2 : 4;
  static constexpr int WG_BYTES = 32 * MT;         // byte columns a warpgroup
  static constexpr int BC = CONSUMERS * WG_BYTES;  // byte columns a tile
  static constexpr int X_BYTES = N * 128;          // N rows x 64 bf16
  static constexpr int W_BYTES = KT * BC;
  static constexpr int STAGE = X_BYTES + W_BYTES;  // a multiple of 1024
  static constexpr int BAR_OFF = STAGES * STAGE;
  static constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 1024;  // + alignment slack
};

struct Args {
  const float* s[2];  // group scales (K / group, n) of each matrix
  float* partial;     // (mats, splits, B, n) fp32
  int B, K, n, cbytes, group;
  int splits, per, col_tiles, units;
};

// The unit's matrix, column tile and reduction rows [r0, r1).
__device__ __forceinline__ void unit_of(const Args& a, int u, int& mat, int& ct, int& split,
                                        int& r0, int& r1) {
  split = u % a.splits;
  ct = (u / a.splits) % a.col_tiles;
  mat = u / (a.splits * a.col_tiles);
  r0 = split * a.per;
  r1 = min(a.K, r0 + a.per);
}

template <int MT>
__device__ __forceinline__ uint32_t load_bytes(const unsigned char* p) {
  if constexpr (MT == 4) return *reinterpret_cast<const uint32_t*>(p);
  if constexpr (MT == 2) return *reinterpret_cast<const uint16_t*>(p);
  return *p;
}

// The loader's place in the CTA's sequence of slots: unit u (a.units past
// the last), its matrix and column tile, and the next reduction row r of
// its rows [r, r1).
struct Cursor {
  int u, mat, ct, r, r1;
};

__device__ __forceinline__ void cursor_at(const Args& a, Cursor& c, int u) {
  c.u = u;
  if (u < a.units) {
    int split;
    unit_of(a, u, c.mat, c.ct, split, c.r, c.r1);
  }
}

template <int N>
__global__ void __launch_bounds__(THREADS, 1)
    fused_mlp_q4c_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap w0map,
                         const __grid_constant__ CUtensorMap w1map, const Args a) {
  using C = Cfg<N>;
  constexpr int MT = C::MT, NR = N / 2;
  extern __shared__ unsigned char q4c_raw[];
  unsigned char* base = align_1024(q4c_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + C::BAR_OFF);
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Thread 0 also loads: slot use `lit` into slot lit % STAGES, once every
  // warp released the slot's previous use. It fills the ring first, then
  // refills one slot at the start of each slot use it >= LAG (use
  // it + STAGES - LAG, into the slot use it - LAG held): STAGES - LAG slots
  // stay in flight ahead of the consumers, and warp 0 waits only for warps
  // that trail it by LAG slots, so the two warpgroups do not run in step.
  const bool loader = threadIdx.x == 0;
  Cursor lc;
  int lit = 0;
  cursor_at(a, lc, blockIdx.x);
  auto load_next = [&]() {
    if (lc.u >= a.units) return;
    const int st = lit % STAGES;
    unsigned char* slot = base + st * C::STAGE;
    mbar_wait(&empty[st], ((lit / STAGES) & 1) ^ 1);
    mbar_expect_tx(&full[st], C::STAGE);
    tma_2d(slot, &xmap, &full[st], lc.r, 0);
    tma_2d(slot + C::X_BYTES, lc.mat ? &w1map : &w0map, &full[st], lc.ct * C::BC, lc.r);
    ++lit;
    lc.r += KT;
    if (lc.r >= lc.r1) cursor_at(a, lc, lc.u + gridDim.x);
  };
  if (loader)
    for (int i = 0; i < STAGES; ++i) load_next();
  __syncwarp();

  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0);
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4, w = warp % 4, g = lane / 4, t = lane % 4;
  const int cw = wg * C::WG_BYTES + MT * (8 * w + g);  // this thread's first byte column
  float c[MT][NR], acc[MT][NR], s_lo[MT], s_hi[MT];
  int it = 0;
  for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
    int mat, ct, split, r0, r1;
    unit_of(a, u, mat, ct, split, r0, r1);
    const float* __restrict__ sc = a.s[mat];
    const int col = ct * C::BC + cw;  // m-tile i's byte column is col + i
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NR; ++j) acc[i][j] = 0.f;
    // acc += c * the scales of the group c summed
    auto flush = [&]() {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        pin(c[i]);
#pragma unroll
        for (int j = 0; j < NR; ++j) acc[i][j] = fmaf(c[i][j], (j & 2) ? s_hi[i] : s_lo[i], acc[i][j]);
      }
    };
    int cur = -1;  // the group c is summing
    int fresh = 1;  // the next product starts c anew
    for (int r = r0; r < r1; r += KT, ++it) {
      const int st = it % STAGES;
      const unsigned char* slot = base + st * C::STAGE;
      const unsigned char* ws = slot + C::X_BYTES + cw;
      const uint64_t xd = desc(reinterpret_cast<const bf16*>(slot), 16, 1024);
      const int steps = min(KT, r1 - r) / 16;
      if (loader && it >= LAG) load_next();
      __syncwarp();
      mbar_wait(&full[st], (it / STAGES) & 1);
      // the slot's weights, decoded first (all of them: rows past K are
      // zeros), so that no decode sits between its products
      uint32_t af[KT / 16][MT][4];
#pragma unroll
      for (int s = 0; s < KT / 16; ++s) {
        const unsigned char* p = ws + (16 * s + 2 * t) * C::BC;
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          // rows 2t, 2t + 1, 2t + 8, 2t + 9; the high nibble to the form v + 8
          const uint32_t v = load_bytes<MT>(p + ((k & 1) + (k >> 1) * 8) * C::BC) ^ 0x80808080u;
          lo[k] = v & 0x0F0F0F0Fu;
          hi[k] = (v >> 4) & 0x0F0F0F0Fu;
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          af[s][i][0] = nibbles(lo[0], lo[1], i);  // row g (low nibble), k 2t, 2t + 1
          af[s][i][1] = nibbles(hi[0], hi[1], i);  // row g + 8 (high nibble)
          af[s][i][2] = nibbles(lo[2], lo[3], i);  // k 2t + 8, 2t + 9
          af[s][i][3] = nibbles(hi[2], hi[3], i);
        }
      }
      // Each step's products are their own wgmma group behind a fence;
      // everything here is uniform across the warpgroup (a branch around a
      // load, as a guarded scale read, made ptxas serialize the wgmma).
#pragma unroll
      for (int s = 0; s < KT / 16; ++s) {
        if (s >= steps) break;
        const int grp = (r + 16 * s) / a.group;
        if (grp != cur) {
          if (cur >= 0) {
            wg_wait<0>();
            flush();
          }
          cur = grp;
          fresh = 1;
          const float* srow = sc + static_cast<size_t>(grp) * a.n;
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const int ci = min(col + i, a.cbytes - 1);  // a valid column, read unguarded
            const float lo = srow[ci], hi = srow[ci + a.n / 2];
            s_lo[i] = col + i < a.cbytes ? lo : 0.f;
            s_hi[i] = col + i < a.cbytes ? hi : 0.f;
          }
        }
        wg_fence();
#pragma unroll
        for (int i = 0; i < MT; ++i) WgmmaRK<N>::run(c[i], af[s][i], xd, kstep(s, N), !fresh);
        wg_commit();
        fresh = 0;
      }
      wg_wait<0>();  // the slot's x is read
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    flush();
    float* __restrict__ out =
        a.partial + static_cast<size_t>(mat * a.splits + split) * a.B * a.n;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (col + i >= a.cbytes) continue;
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        // accumulator j: x row 8 (j / 4) + 2t + (j & 1); the high nibble's
        // column when j & 2
        const int b = 8 * (j / 4) + 2 * t + (j & 1);
        if (b < a.B) out[static_cast<size_t>(b) * a.n + col + i + ((j & 2) ? a.n / 2 : 0)] = acc[i][j];
      }
    }
  }
}

// x (B, K) bf16 @ the `mats` q4c matrices (K, n / 2) with scales (K / group,
// n): each unit's fp32 partial result into `partial` (mats, splits, B, n).
template <int N>
int launch(const void* x, const void* w0, const void* s0, const void* w1, const void* s1,
           void* partial, int B, int K, int n, int group, int mats, int splits, int per,
           int grid, cudaStream_t stream) {
  using C = Cfg<N>;
  Args a;
  a.s[0] = static_cast<const float*>(s0);
  a.s[1] = static_cast<const float*>(s1);
  a.partial = static_cast<float*>(partial);
  a.B = B;
  a.K = K;
  a.n = n;
  a.cbytes = n / 2;
  a.group = group;
  a.splits = splits;
  a.per = per;
  a.col_tiles = (a.cbytes + C::BC - 1) / C::BC;
  a.units = mats * a.col_tiles * splits;
  CUtensorMap xm, wm[2];
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(B)};
  const cuuint64_t xstrides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t xbox[2] = {KT, N};
  int e = encode_map(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xdims, xstrides, xbox,
                     CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(a.cbytes), static_cast<cuuint64_t>(K)};
  const cuuint64_t wstrides[1] = {static_cast<cuuint64_t>(a.cbytes)};
  const cuuint32_t wbox[2] = {C::BC, KT};
  const void* ws[2] = {w0, w1};
  for (int m = 0; m < 2 && e == 0; ++m)
    e = encode_map(&wm[m], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, ws[m], wdims, wstrides, wbox,
                   CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
  if (e != 0) return e;
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_q4c_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  fused_mlp_q4c_kernel<N><<<grid, THREADS, C::SMEM, stream>>>(xm, wm[0], wm[1], a);
  return cudaGetLastError();
}

// The N (rows of x a product serves) for B rows.
int launch_rows(const void* x, const void* w0, const void* s0, const void* w1, const void* s1,
                void* partial, int B, int K, int n, int group, int mats, int splits, int per,
                int grid, cudaStream_t stream) {
  if (B < 1 || B > 128 || K % 16 || n % 32 || group < 16 || group % 16 || K % group ||
      per < KT || per % KT || splits < 1 || static_cast<long long>(splits) * per < K ||
      static_cast<long long>(splits - 1) * per >= K || grid < 1 || mats < 1 || mats > 2 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w0) % 16 ||
      reinterpret_cast<uintptr_t>(w1) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
#define Q4C_N(NN) \
  return launch<NN>(x, w0, s0, w1, s1, partial, B, K, n, group, mats, splits, per, grid, stream)
  if (B <= 8) Q4C_N(8);
  if (B <= 16) Q4C_N(16);
  if (B <= 32) Q4C_N(32);
  if (B <= 64) Q4C_N(64);
  Q4C_N(128);
#undef Q4C_N
}

}  // namespace q4c

// ---------------------------------------------------------------------------
// K5, K6 and K7 for Hopper: one streaming weight-only core (wo::), a
// template over the layout (q4c: two int4 a byte, two output columns, a
// scale per group of `group` reduction rows; q4p: two int4 a byte, one
// output column and two reduction rows, i and i + K / 2, scales as q4c;
// q8: one int8 a byte, the column's scale applied by the merge) and over N,
// the rows of x a unit serves (8, 16, 32 or 64, and 24 for int4; above 64
// rows a unit serves one 64-row block of x).
//
// Bound: the weight bytes (int4 up to about 74 rows, int8 up to 128), so the
// core is a stream of weight tiles past consumers that must keep up with the
// card's memory rate. chip_smoke.py --phases wo_probe times its phases per
// slot (readings in PERF.md). Its design:
// - The products run on mma.sync m16n8k16 with the decoded weights as A
//   ("swap AB") and x as B: a warp issues them with no warpgroup fence or
//   drain, and the decode of the next m-tiles overlaps the products in
//   flight.
// - Groups of G warps share one 128-byte column strip. Each group has its
//   own ring of `stages` slots on its own mbarriers; a ninth warp only
//   loads (its lane j issues group j's TMA copies as slots free up), so no
//   consumer stalls on a copy's issue and no warp waits for a warp of
//   another group. A slot holds KW = 64 reduction rows of the strip (8 KB,
//   the 128-byte swizzle), the same 64 columns of x (N rows, the 128-byte
//   swizzle) and, for q4c, where scale groups end in the slot, their scales
//   for the strip's 256 output columns: no global load in the loop. (Slots
//   of 32 rows, 4 KB, held even idle consumers to 1.8 to 2.6 TB/s, as if
//   each copy cost the SM 150 to 240 cycles to issue; 64 rows reach 2.8.)
// - Lane (g, t) reads rows 2t, 2t + 1, 2t + 8 and 2t + 9 of a 16-row step,
//   16 / G bytes of chunk g of each: under the 128-byte swizzle the lanes of
//   a quarter warp hit 8 different 16-byte bank groups (chunk g ^ 2t), so a
//   16-byte read has no bank conflict.
// - Decode without I2F: a q4c nibble by masks into 0x43XX (bf16 128 + v +
//   8), two m-tiles a __byte_perm, and one bf16 subtraction; an int8 byte
//   by __byte_perm into 0x4B0000XX (fp32 2^23 + v + 128), one FADD and the
//   high half.
// - q4p (K7) reads its bytes as stored, no repacking. A slot's 64 byte rows
//   hold reduction rows [r, r + 64) in the low nibbles and [r + K / 2,
//   r + K / 2 + 64) in the high ones, so it brings two boxes of x (columns
//   r and r + K / 2). A lane's byte columns 2j and 2j + 1 are rows g and
//   g + 8 of m-tile j: the low nibbles are its A fragment for the low
//   half's k-step, the high nibbles for the high half's, two mma.sync an
//   m-tile and 16-row step (as many products a byte as q4c). Both nibbles
//   are two's complement (q4c's high-nibble decode). The core takes q4p
//   where K / 2 is a multiple of the group: a low-half group and its
//   high-half partner (group index + K / (2 group)) then end in the same
//   slot, which brings both scale rows by TMA, and each m-tile keeps three
//   sets of sums (the two halves' group sums and the scaled total), fewer
//   registers than q4c's two sets of twice the m-tiles. The same bound
//   holds: the bytes, 94 MB for an 8B layer's MLP, up to about 74 rows.
//   G and N as q4c's. wo_kernel<1, N> at N 8 / 16 / 24 / 32 / 64: 96 /
//   135 / 115 / 139 / 154 registers, no spills, 32 / 64 / 48 / 64 / 64
//   HMMA (chip_smoke.py phase 2, H100). The probe (PERF.md) finds
//   its decode (about 1500 cycles a slot at 1 row, as q4c's) as long as a
//   group's slot takes to stream, so at 1 row an 8B gate/up product runs
//   about a quarter over idle consumers: the consumers, not the stream,
//   bound it, and 64-row blocks re-read the weights above 64 rows.
// - Persistent CTAs (at most one a SM) of 8 consumer warps and the loading
//   warp (so at most 168 registers a thread). Worker w (group j of CTA
//   c, w = j * grid + c) takes units w, w + workers, ...: (matrix, row
//   block, split of `per` reduction rows, strip), strips fastest. Each unit
//   writes its fp32 partial result to its own slot, and the merges add the
//   splits in a fixed order: equal bits run to run, no atomics.
namespace wo {

constexpr int KW = 64;                  // reduction rows a slot
constexpr int STRIP = 128;              // byte columns a group streams
constexpr int WARPS = 8;                // consumer warps; warp 8 loads
constexpr int THREADS = (WARPS + 1) * 32;
constexpr int W_BYTES = KW * STRIP;     // a slot's weight bytes
constexpr int S_ROW = STRIP * 4;        // one scale row of a strip's byte columns, fp32
constexpr int MAX_STAGES = 32;
constexpr int SMEM_BUDGET = 227 * 1024;

// Probe modes (built only with -DWO_PROBE, for chip_smoke.py --phases
// wo_probe): the core as built timed phase by phase, and three cut-down
// consumers: wait and release only, read every byte, read and decode.
enum Mode { RUN = 0, TIMED = 1, IDLE = 2, READ = 3, DECODE = 4 };
// per-warp counters of a probe: cycles a phase summed over slots, slots,
// the warp's cycles in all, and a sink that keeps cut-down work alive
enum Counter { P_WAIT, P_LOAD, P_DECODE, P_MMA, P_FLUSH, P_RELEASE, P_SLOTS, P_TOTAL, P_SINK,
               P_SAMPLED, P_COUNT };
// TIMED instruments one slot use in SAMPLE (the clock reads and the order
// they force between phases slow a slot down; odd, so that the uses timed
// fall on both slots of a 128-row scale group); the cut-down modes, every
// use.
constexpr int SAMPLE = 7;

template <int LAYOUT, int N>
struct Cfg {
  static_assert(N == 8 || N == 16 || N == 24 || N == 32 || N == 64, "N");
  static constexpr int NT = N / 8;  // n-tiles of x rows
  // warps a strip: each keeps MTW * NT * 4 accumulators, 64 for int8,
  // twice 64 for q4c's group sums and three times 48 for q4p's (half q4c's
  // m-tiles), within the 168 registers a thread of 9 warps has (ptxas
  // spilled int8 at 128)
  static constexpr int G = LAYOUT != Q8 ? (NT == 3 ? 4 : NT > 2 ? NT : 2) : (NT > 2 ? NT / 2 : 1);
  static constexpr int GPC = WARPS / G;                    // groups a CTA
  static constexpr int LB = 16 / G;                        // bytes a lane reads of a row
  static constexpr int MTW = LAYOUT == Q4C ? LB : LB / 2;  // m-tiles a warp
  // fp32 a lane stores of one x row: q4p's LB byte columns, or MTW columns
  // twice (q4c's low and high nibbles, int8's rows g and g + 8)
  static constexpr int SPAN = LAYOUT == Q4P ? LB : MTW;
  static constexpr int VEC = SPAN < 4 ? SPAN : 4;          // fp32 a store
  static constexpr int XB = LAYOUT == Q4P ? 2 : 1;         // boxes of x a slot
  static constexpr int X_BOX = N * KW * 2;                 // N rows of 128 bytes
  static constexpr int X_BYTES = XB * X_BOX;
};

struct Args {
  float* partial;             // (mats, splits, B, n) fp32
  unsigned long long* probe;  // probe builds: P_COUNT counters a warp
  int B, rows, n, cbytes, group;  // rows: the byte matrix's (K / 2 for q4p)
  int splits, per, strips, rblocks, units;
  int stages, slot, sr;  // ring slots a group, bytes a slot, int4 scale rows a slot
  // where a slot's second box of x and of scales start: q4p's x at column
  // xhi = K / 2 and its scales at row shi = K / (2 group) further; q4c's
  // scales at column scol = n / 2
  int xhi, shi, scol;
};

__device__ __forceinline__ void unit_of(const Args& a, int u, int& mat, int& rb, int& split,
                                        int& strip) {
  strip = u % a.strips;
  u /= a.strips;
  split = u % a.splits;
  u /= a.splits;
  rb = u % a.rblocks;
  mat = u / a.rblocks;
}

// The first int4 scale row the slot of rows [r, r + KW) needs: every group
// ending in it (sr rows from it when groups are shorter than a slot), or -1.
__device__ __forceinline__ int scale_row(const Args& a, int r) {
  const int grp = r / a.group;
  return (a.group < KW || (grp + 1) * a.group <= r + KW) ? grp : -1;
}

__device__ __forceinline__ unsigned long long clock_now() {
  unsigned long long c;
  asm volatile("mov.u64 %0, %%clock64;\n" : "=l"(c)::"memory");
  return c;
}

// d += a * b on mma.sync; volatile where a probe must keep it in its phase
// Whether the phase of the given parity has completed (no wait).
__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

template <bool V>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  if constexpr (V) {
    mma16816(d, a, b[0], b[1]);
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

template <int LB>
__device__ __forceinline__ void lds(uint32_t (&w)[(LB + 3) / 4], const unsigned char* p) {
  if constexpr (LB == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else if constexpr (LB == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else if constexpr (LB == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    w[0] = *reinterpret_cast<const uint16_t*>(p);
  }
}

// bf16 pair minus 136: v + 8 in [0, 15] as 0x43XX (128 + v + 8) -> v
__device__ __forceinline__ uint32_t less136(uint32_t v) {
  const uint32_t bias = 0x43084308u;
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v),
                             *reinterpret_cast<const __nv_bfloat162*>(&bias));
  return *reinterpret_cast<uint32_t*>(&r);
}

// The nibbles at bits 0-3 and 16-19 of v as a bf16 pair: q4c's low nibble
// (stored as v + 8), and its high nibble (two's complement: bit 3 flipped).
__device__ __forceinline__ uint32_t q4_lo(uint32_t v) { return less136((v & 0x000F000Fu) | 0x43004300u); }
__device__ __forceinline__ uint32_t q4_hi(uint32_t v) { return less136((v & 0x000F000Fu) ^ 0x43084308u); }

// The A fragments of m-tiles j and j + 1 (bytes j, j + 1 of words r0..r3
// of rows 2t, 2t + 1, 2t + 8, 2t + 9): row g the low nibble's column, row
// g + 8 the high nibble's. j is 0 or 2, known after unrolling.
__device__ __forceinline__ void q4_pair(uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3, int j,
                                        uint32_t (&fa)[4], uint32_t (&fb)[4]) {
  const uint32_t sel = j | ((j + 1) << 4) | ((j + 4) << 8) | ((j + 5) << 12);
  const uint32_t p = __byte_perm(r0, r1, sel), q = __byte_perm(r2, r3, sel);
  fa[0] = q4_lo(p);
  fa[1] = q4_hi(p >> 4);
  fa[2] = q4_lo(q);
  fa[3] = q4_hi(q >> 4);
  fb[0] = q4_lo(p >> 8);
  fb[1] = q4_hi(p >> 12);
  fb[2] = q4_lo(q >> 8);
  fb[3] = q4_hi(q >> 12);
}

// q4p: the A fragments of m-tile j / 2 (bytes j, j + 1 of words r0..r3 of
// byte rows 2t, 2t + 1, 2t + 8, 2t + 9 are its rows g and g + 8) for the
// low half's k-step (lo: the low nibbles) and the high half's (hi). Both
// nibbles are two's complement. j is 0 or 2, known after unrolling.
__device__ __forceinline__ void q4p_pair(uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3, int j,
                                         uint32_t (&lo)[4], uint32_t (&hi)[4]) {
  const uint32_t sel = j | ((j + 1) << 4) | ((j + 4) << 8) | ((j + 5) << 12);
  const uint32_t p = __byte_perm(r0, r1, sel), q = __byte_perm(r2, r3, sel);
  lo[0] = q4_hi(p);
  lo[1] = q4_hi(p >> 8);
  lo[2] = q4_hi(q);
  lo[3] = q4_hi(q >> 8);
  hi[0] = q4_hi(p >> 4);
  hi[1] = q4_hi(p >> 12);
  hi[2] = q4_hi(q >> 4);
  hi[3] = q4_hi(q >> 12);
}

// Byte i of x and of y (words xored with 0x80808080, so a byte is v + 128)
// as the bf16 pair (x's, y's), exact: fp32 0x4B0000XX is 2^23 + v + 128.
__device__ __forceinline__ uint32_t q8_pair(uint32_t x, uint32_t y, int i) {
  const uint32_t sel = i | (4 << 4) | (4 << 8) | (7 << 12);  // byte i, 0, 0, 0x4B
  const float fx = __uint_as_float(__byte_perm(x, 0x4B000000u, sel)) - 8388736.f;
  const float fy = __uint_as_float(__byte_perm(y, 0x4B000000u, sel)) - 8388736.f;
  return __byte_perm(__float_as_uint(fx), __float_as_uint(fy), 0x7632);
}

template <int LAYOUT, int N, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    wo_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap w0map,
              const __grid_constant__ CUtensorMap w1map, const __grid_constant__ CUtensorMap s0map,
              const __grid_constant__ CUtensorMap s1map, const Args a) {
  using C = Cfg<LAYOUT, N>;
  constexpr int NT = C::NT, G = C::G, LB = C::LB, MTW = C::MTW, NW = (LB + 3) / 4;
  constexpr int SPAN = C::SPAN, VEC = C::VEC;
  constexpr bool Q4 = LAYOUT == Q4C, P4 = LAYOUT == Q4P, INT4 = LAYOUT != Q8;
  constexpr bool PRODUCTS = MODE == RUN || MODE == TIMED;
  extern __shared__ unsigned char wo_raw[];
  // 1024-aligned by an offset from the shared array, so loads stay LDS
  unsigned char* base = wo_raw + ((1024u - (smem_u32(wo_raw) & 1023u)) & 1023u);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + C::GPC * a.stages * a.slot);
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0);
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int j = 0; j < C::GPC; ++j)
      for (int i = 0; i < a.stages; ++i) {
        mbar_init(&bars[j * 2 * MAX_STAGES + i], 1);               // full
        mbar_init(&bars[j * 2 * MAX_STAGES + MAX_STAGES + i], G);  // empty
      }
    mbar_fence_init();
  }
  __syncthreads();
  const int workers = gridDim.x * C::GPC;

  if (warp == WARPS) {
    // The loading warp: lane j fills group j's ring, slot use after slot
    // use, as soon as the group's warps released the slot's previous use.
    // Its cursor: unit u, its matrix, row block and strip, the next row r
    // of [r, r1), and the slot and parity of the next use.
    const int j = lane;
    unsigned char* ring = base + j * a.stages * a.slot;
    uint64_t* full = bars + j * 2 * MAX_STAGES;
    uint64_t* empty = full + MAX_STAGES;
    int u = j * gridDim.x + blockIdx.x, mat = 0, rb = 0, strip = 0, r = 0, r1 = 0, st = 0, ph = 0;
    auto start = [&]() {
      if (u < a.units) {
        int split;
        unit_of(a, u, mat, rb, split, strip);
        r = split * a.per;
        r1 = min(a.rows, r + a.per);
      }
    };
    start();
    bool more = j < C::GPC && u < a.units;
    while (__any_sync(0xffffffffu, more)) {
      bool issued = false;
      if (more && mbar_test(&empty[st], ph ^ 1)) {
        unsigned char* slot = ring + st * a.slot;
        const int srow = INT4 ? scale_row(a, r) : -1;
        mbar_expect_tx(&full[st], W_BYTES + C::X_BYTES + (srow >= 0 ? 2 * a.sr * S_ROW : 0));
        tma_2d(slot, mat ? &w1map : &w0map, &full[st], strip * STRIP, r);
        tma_2d(slot + W_BYTES, &xmap, &full[st], r, rb * N);
        if constexpr (P4)  // the high nibbles' reduction rows
          tma_2d(slot + W_BYTES + C::X_BOX, &xmap, &full[st], a.xhi + r, rb * N);
        if (srow >= 0) {
          // q4c: the low and high nibbles' columns; q4p: the two halves' groups
          const CUtensorMap* sm = mat ? &s1map : &s0map;
          unsigned char* dst = slot + W_BYTES + C::X_BYTES;
          tma_2d(dst, sm, &full[st], strip * STRIP, srow);
          tma_2d(dst + a.sr * S_ROW, sm, &full[st], a.scol + strip * STRIP, a.shi + srow);
        }
        if (++st == a.stages) {
          st = 0;
          ph ^= 1;
        }
        r += KW;
        if (r >= r1) {
          u += workers;
          start();
          more = u < a.units;
        }
        issued = true;
      }
      if (!__any_sync(0xffffffffu, issued)) __nanosleep(64);
    }
    return;
  }

  const int g = lane / 4, t = lane % 4;
  const int grp = warp / G, q = warp % G;
  const unsigned char* ring = base + grp * a.stages * a.slot;
  uint64_t* full = bars + grp * 2 * MAX_STAGES;
  uint64_t* empty = full + MAX_STAGES;

  unsigned long long pc[P_COUNT] = {};
  unsigned long long tick = 0;
  if constexpr (MODE != RUN) pc[P_TOTAL] = clock_now();
  uint32_t sink = 0;

  // c: the running group's sums (q4p: its low half's, c2 its high half's);
  // acc: the int4 groups' scaled sums
  float c[MTW][NT][4];
  float c2[P4 ? MTW : 1][P4 ? NT : 1][4];
  float acc[INT4 ? MTW : 1][INT4 ? NT : 1][4];
  int st = 0, ph = 0, used = 0;
  for (int u = grp * gridDim.x + blockIdx.x; u < a.units; u += workers) {
    int mat, rb, split, strip;
    unit_of(a, u, mat, rb, split, strip);
    const int r0 = split * a.per, r1 = min(a.rows, r0 + a.per);
#pragma unroll
    for (int j = 0; j < MTW; ++j)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          c[j][nt][e] = 0.f;
          if constexpr (P4) c2[j][nt][e] = 0.f;
          if constexpr (INT4) acc[j][nt][e] = 0.f;
        }
    int next_end = (r0 / a.group + 1) * a.group;  // int4: the next group's end
    for (int r = r0; r < r1; r += KW) {
      auto use = [&](auto probed) {
        constexpr bool P = decltype(probed)::value;
        auto mark = [&](int counter) {
          if constexpr (P) {
            const unsigned long long now = clock_now();
            pc[counter] += now - tick;
            tick = now;
          }
        };
        if constexpr (P) tick = clock_now();
        mbar_wait(&full[st], ph);
        mark(P_WAIT);
        const unsigned char* slot = ring + st * a.slot;
        const unsigned char* xs = slot + W_BYTES;
        const float* ss = reinterpret_cast<const float*>(xs + C::X_BYTES);
        int ends = 0;  // int4: the groups ended in this slot so far
#pragma unroll
        for (int s = 0; s < KW / 16; ++s) {
          if constexpr (MODE != IDLE) {
            if (r + 16 * s >= r1) break;
            // weights: rows 2t (+ 8) in chunk g ^ 2t, rows 2t + 1 (+ 8) in g ^ (2t + 1)
            const unsigned char* row = slot + (16 * s + 2 * t) * STRIP + q * LB;
            const int c0 = (g ^ (2 * t)) << 4, c1 = (g ^ (2 * t + 1)) << 4;
            uint32_t R[4][NW];
            lds<LB>(R[0], row + c0);
            lds<LB>(R[1], row + STRIP + c1);
            lds<LB>(R[2], row + 8 * STRIP + c0);
            lds<LB>(R[3], row + 9 * STRIP + c1);
            // x: bx[h][nt] = rows 8 nt + g, columns 16 s + 2t (+ 8) of box h
            // (q4p's box 1: the high half), by ldmatrix of two n-tiles at a
            // time: lane L gives row 8 (nt + L / 16) + L % 8 of chunk
            // 2s + (L / 8) % 2, stored at chunk ^ (row % 8)
            uint32_t bx[C::XB][NT][2];
#pragma unroll
            for (int h = 0; h < C::XB; ++h)
#pragma unroll
              for (int nt = 0; nt < NT; nt += 2) {
                const int xr = 8 * (nt + lane / 16) + lane % 8;
                const int ch = (2 * s + (lane / 8) % 2) ^ (xr & 7);
                const uint32_t addr = smem_u32(xs + h * C::X_BOX + xr * 128 + (ch << 4));
                if (nt + 1 == NT)
                  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                               : "=r"(bx[h][nt][0]), "=r"(bx[h][nt][1])
                               : "r"(addr));
                else
                  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                               : "=r"(bx[h][nt][0]), "=r"(bx[h][nt][1]),
                                 "=r"(bx[h][nt + 1 < NT ? nt + 1 : nt][0]),
                                 "=r"(bx[h][nt + 1 < NT ? nt + 1 : nt][1])
                               : "r"(addr));
              }
            if constexpr (P) {
#pragma unroll
              for (int k = 0; k < 4; ++k)
#pragma unroll
                for (int w = 0; w < NW; ++w) sink ^= R[k][w];
#pragma unroll
              for (int h = 0; h < C::XB; ++h)
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) sink ^= bx[h][nt][0] ^ bx[h][nt][1];
              mark(P_LOAD);
            }
            if constexpr (MODE == READ) continue;
            uint32_t fr[MTW][4];
            uint32_t fr2[P4 ? MTW : 1][4];  // q4p: the high half's fragments
            if constexpr (Q4) {
#pragma unroll
              for (int w = 0; w < NW; ++w)
#pragma unroll
                for (int j = 0; j < (LB < 4 ? LB : 4); j += 2)
                  q4_pair(R[0][w], R[1][w], R[2][w], R[3][w], j, fr[4 * w + j], fr[4 * w + j + 1]);
            } else if constexpr (P4) {
#pragma unroll
              for (int w = 0; w < NW; ++w)
#pragma unroll
                for (int j = 0; j < (LB < 4 ? LB : 4); j += 2)
                  q4p_pair(R[0][w], R[1][w], R[2][w], R[3][w], j, fr[(4 * w + j) / 2],
                           fr2[(4 * w + j) / 2]);
            } else {
#pragma unroll
              for (int k = 0; k < 4; ++k)
#pragma unroll
                for (int w = 0; w < NW; ++w) R[k][w] ^= 0x80808080u;
#pragma unroll
              for (int j = 0; j < MTW; ++j) {
                const int i = j + MTW;  // row g + 8's byte
                fr[j][0] = q8_pair(R[0][j / 4], R[1][j / 4], j % 4);
                fr[j][1] = q8_pair(R[0][i / 4], R[1][i / 4], i % 4);
                fr[j][2] = q8_pair(R[2][j / 4], R[3][j / 4], j % 4);
                fr[j][3] = q8_pair(R[2][i / 4], R[3][i / 4], i % 4);
              }
            }
            if constexpr (P) {
#pragma unroll
              for (int j = 0; j < MTW; ++j) {
                sink ^= fr[j][0] ^ fr[j][1] ^ fr[j][2] ^ fr[j][3];
                if constexpr (P4) sink ^= fr2[j][0] ^ fr2[j][1] ^ fr2[j][2] ^ fr2[j][3];
              }
              mark(P_DECODE);
            }
            if constexpr (PRODUCTS) {
#pragma unroll
              for (int j = 0; j < MTW; ++j)
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) {
                  mma<P>(c[j][nt], fr[j], bx[0][nt]);
                  if constexpr (P4) mma<P>(c2[j][nt], fr2[j], bx[C::XB - 1][nt]);
                }
              mark(P_MMA);
              if constexpr (INT4) {
                // a group ends: acc += c * its scales, c = 0
                if (r + 16 * (s + 1) == next_end) {
                  next_end += a.group;
                  // the slot's scale rows are its groups' in order: q4c's low
                  // nibbles' (sl) and high nibbles' (sh) columns, q4p's low
                  // half's group (sl) and high half's (sh)
                  const float* sl = ss + (ends++) * STRIP + 16 * g + q * LB;
                  const float* sh = sl + a.sr * STRIP;
#pragma unroll
                  for (int j = 0; j < MTW; ++j) {
                    // the scales of rows g and g + 8 of m-tile j: q4c's byte
                    // column j in the two halves of the columns; q4p's byte
                    // columns 2j and 2j + 1, each in the two halves of K
                    const float lo = Q4 ? sl[j] : sl[2 * j], hi = Q4 ? sh[j] : sl[2 * j + 1];
                    const float lo2 = P4 ? sh[2 * j] : 0.f, hi2 = P4 ? sh[2 * j + 1] : 0.f;
#pragma unroll
                    for (int nt = 0; nt < NT; ++nt) {
                      if constexpr (P4) {
                        acc[j][nt][0] = fmaf(c2[j][nt][0], lo2, fmaf(c[j][nt][0], lo, acc[j][nt][0]));
                        acc[j][nt][1] = fmaf(c2[j][nt][1], lo2, fmaf(c[j][nt][1], lo, acc[j][nt][1]));
                        acc[j][nt][2] = fmaf(c2[j][nt][2], hi2, fmaf(c[j][nt][2], hi, acc[j][nt][2]));
                        acc[j][nt][3] = fmaf(c2[j][nt][3], hi2, fmaf(c[j][nt][3], hi, acc[j][nt][3]));
#pragma unroll
                        for (int e = 0; e < 4; ++e) c2[j][nt][e] = 0.f;
                      } else {
                        acc[j][nt][0] = fmaf(c[j][nt][0], lo, acc[j][nt][0]);
                        acc[j][nt][1] = fmaf(c[j][nt][1], lo, acc[j][nt][1]);
                        acc[j][nt][2] = fmaf(c[j][nt][2], hi, acc[j][nt][2]);
                        acc[j][nt][3] = fmaf(c[j][nt][3], hi, acc[j][nt][3]);
                      }
#pragma unroll
                      for (int e = 0; e < 4; ++e) c[j][nt][e] = 0.f;
                    }
                  }
                  mark(P_FLUSH);
                }
              }
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
        mark(P_RELEASE);
        if constexpr (P) ++pc[P_SAMPLED];
      };
      if constexpr (MODE == TIMED) {
        if (used % SAMPLE == 0)
          use(std::true_type{});
        else
          use(std::false_type{});
      } else {
        use(std::integral_constant<bool, MODE != RUN>{});
      }
      if (++st == a.stages) {
        st = 0;
        ph ^= 1;
      }
      ++used;
    }
    if constexpr (PRODUCTS) {
      // x row xr's SPAN columns from bc (a 16-byte chunk lies wholly inside
      // or outside the matrix: cbytes is a multiple of 16): accumulators e
      // 0, 1 hold row g's (q4c: the low nibbles' columns, bc + j; int8: byte
      // bc + j; q4p: byte bc + 2j), e 2, 3 row g + 8's (q4c: the high
      // nibbles', n / 2 + bc + j; int8: bc + MTW + j; q4p: bc + 2j + 1,
      // stored with row g's)
      float* __restrict__ out =
          a.partial + static_cast<size_t>(mat * a.splits + split) * a.B * a.n;
      const int bc = strip * STRIP + 16 * g + q * LB;
      if (bc < a.cbytes) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < (P4 ? 2 : 4); ++e) {
            const int xr = rb * N + 8 * nt + 2 * t + (e & 1);
            if (xr >= a.B) continue;
            float* dst = out + static_cast<size_t>(xr) * a.n + bc +
                         (e < 2 ? 0 : (Q4 ? a.n / 2 : MTW));
#pragma unroll
            for (int j0 = 0; j0 < SPAN; j0 += VEC) {
              float v[VEC];
#pragma unroll
              for (int i = 0; i < VEC; ++i) {
                if constexpr (P4)
                  v[i] = acc[(j0 + i) / 2][nt][e + 2 * ((j0 + i) % 2)];
                else if constexpr (Q4)
                  v[i] = acc[j0 + i][nt][e];
                else
                  v[i] = c[j0 + i][nt][e];
              }
              if constexpr (VEC == 4)
                *reinterpret_cast<float4*>(dst + j0) = make_float4(v[0], v[1], v[2], v[3]);
              else if constexpr (VEC == 2)
                *reinterpret_cast<float2*>(dst + j0) = make_float2(v[0], v[1]);
              else
                dst[j0] = v[0];
            }
          }
      }
    }
  }
  if constexpr (MODE != RUN) {
    pc[P_SLOTS] = used;
    pc[P_TOTAL] = clock_now() - pc[P_TOTAL];
    pc[P_SINK] = sink;
    if (lane == 0)
      for (int i = 0; i < P_COUNT; ++i)
        a.probe[(static_cast<size_t>(blockIdx.x) * WARPS + warp) * P_COUNT + i] = pc[i];
  }
}

// x (B, K) bf16 @ the `mats` matrices (K, n) of the layout: each unit's fp32
// partial result into `partial` (mats, splits, B, n). K is the reduction
// dim (the byte matrix has K / 2 rows for q4p), per a split's byte rows.
// Returns 0 or a CUDA error code.
template <int LAYOUT, int N, int MODE>
int launch(const void* x, const void* w0, const void* s0, const void* w1, const void* s1,
           void* partial, unsigned long long* probe, int B, int K, int n, int group, int mats,
           int splits, int per, int grid, cudaStream_t stream) {
  using C = Cfg<LAYOUT, N>;
  constexpr bool INT4 = LAYOUT != Q8;
  Args a;
  a.partial = static_cast<float*>(partial);
  a.probe = probe;
  a.B = B;
  a.rows = LAYOUT == Q4P ? K / 2 : K;
  a.n = n;
  a.cbytes = LAYOUT == Q4C ? n / 2 : n;
  a.group = INT4 ? group : K;
  a.xhi = LAYOUT == Q4P ? K / 2 : 0;
  a.shi = LAYOUT == Q4P ? K / 2 / group : 0;
  a.scol = LAYOUT == Q4C ? n / 2 : 0;
  a.splits = splits;
  a.per = per;
  a.strips = (a.cbytes + STRIP - 1) / STRIP;
  a.rblocks = (B + N - 1) / N;
  a.units = mats * a.rblocks * splits * a.strips;
  a.sr = INT4 && group < KW ? KW / group : 1;
  const int s_bytes = INT4 ? 2 * a.sr * S_ROW : 0;
  a.slot = (W_BYTES + C::X_BYTES + s_bytes + 1023) / 1024 * 1024;
  const int bars = C::GPC * 2 * MAX_STAGES * 8;
  a.stages = min(MAX_STAGES, (SMEM_BUDGET - 1024 - bars) / (C::GPC * a.slot));
  if (a.stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = C::GPC * a.stages * a.slot + bars + 1024;
  CUtensorMap xm, wm[2], sm[2];
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(B)};
  const cuuint64_t xstrides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t xbox[2] = {KW, N};
  int e = encode_map(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xdims, xstrides, xbox,
                     CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(a.cbytes),
                               static_cast<cuuint64_t>(a.rows)};
  const cuuint64_t wstrides[1] = {static_cast<cuuint64_t>(a.cbytes)};
  const cuuint32_t wbox[2] = {STRIP, KW};
  const cuuint64_t sdims[2] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(K / a.group)};
  const cuuint64_t sstrides[1] = {static_cast<cuuint64_t>(n) * 4};
  const cuuint32_t sbox[2] = {STRIP, static_cast<cuuint32_t>(a.sr)};
  const void* ws[2] = {w0, w1};
  const void* ss[2] = {s0, s1};
  for (int m = 0; m < 2 && e == 0; ++m) {
    e = encode_map(&wm[m], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, ws[m], wdims, wstrides, wbox,
                   CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
    if (e == 0 && INT4)
      e = encode_map(&sm[m], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, ss[m], sdims, sstrides, sbox,
                     CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
    else
      sm[m] = wm[m];  // int8: no scales in the kernel
  }
  if (e != 0) return e;
  cudaError_t err = cudaFuncSetAttribute(wo_kernel<LAYOUT, N, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wo_kernel<LAYOUT, N, MODE><<<grid, THREADS, smem, stream>>>(xm, wm[0], wm[1], sm[0], sm[1], a);
  return static_cast<int>(cudaGetLastError());
}

// Checks the arguments and picks the instance: design is N (8, 16, 32 or 64,
// and 24 for int4; 64-row blocks above 64 rows). The byte rows (K, or K / 2
// for q4p) are a multiple of 16; an int4 group is a multiple of 16 that
// divides a slot or is a multiple of one, and divides the byte rows (for
// q4p: a low-half group and its high-half partner end in one slot).
// ops/fused_mlp.py::_wo_takes holds the same rule before any launch.
template <int MODE>
int launch_design(int layout, int design, const void* x, const void* w0, const void* s0,
                  const void* w1, const void* s1, void* partial, unsigned long long* probe, int B,
                  int K, int n, int group, int mats, int splits, int per, int grid,
                  cudaStream_t stream) {
  const bool int4 = layout == Q4C || layout == Q4P;
  const int cbytes = layout == Q4C ? n / 2 : n;
  const int rows = layout == Q4P ? K / 2 : K;
  // splits start on a slot and (int4) on a group: a multiple of the larger
  // of KW and the group, one of which divides the other
  const int align = int4 && group > KW ? group : KW;
  if ((!int4 && layout != Q8) || B < 1 || B > 128 || K % 2 || rows < 16 || rows % 16 || n < 2 ||
      cbytes % 16 ||
      (int4 && (n % 2 || group < 16 || group % 16 || rows % group || (group % KW && KW % group))) ||
      per < KW || per % KW || (splits > 1 && per % align) || splits < 1 ||
      static_cast<long long>(splits) * per < rows ||
      static_cast<long long>(splits - 1) * per >= rows || grid < 1 || mats < 1 || mats > 2 ||
      (design < B && design != 64) ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w0) % 16 ||
      reinterpret_cast<uintptr_t>(w1) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  // a probe build's cut-down modes exist for the designs of 1 and 20 rows
  constexpr bool ALL = MODE == RUN;
#define WO_N(L, NN)                                                                              \
  if (design == NN)                                                                              \
  return launch<L, NN, MODE>(x, w0, s0, w1, s1, partial, probe, B, K, n, group, mats, splits, \
                             per, grid, stream)
  if (layout == Q4C) {
    WO_N(Q4C, 8);
    WO_N(Q4C, 24);
    if constexpr (ALL) {
      WO_N(Q4C, 16);
      WO_N(Q4C, 32);
      WO_N(Q4C, 64);
    }
  } else if (layout == Q4P) {
    WO_N(Q4P, 8);
    WO_N(Q4P, 24);
    if constexpr (ALL) {
      WO_N(Q4P, 16);
      WO_N(Q4P, 32);
      WO_N(Q4P, 64);
    }
  } else {
    WO_N(Q8, 8);
    WO_N(Q8, 32);
    if constexpr (ALL) {
      WO_N(Q8, 16);
      WO_N(Q8, 64);
    }
  }
#undef WO_N
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace wo

}  // namespace

// The SwiGLU MLP: out (B, D) fp32 = (silu(x @ Wg) * (x @ Wu)) @ Wd.
// layout: 0 = q4c, 1 = q4p, 2 = int8. x (B, D) bf16. h: (B, F) bf16
// workspace. partial: fp32 workspace of max(2 * split1 * B * F,
// split2 * B * D) elements. group_d / group_f: reduction rows per scale
// group of the gate/up and of the down matrices (int8: D and F). splitN and
// perN: the splits of product N's reduction and the byte-matrix rows per
// split (a multiple of 16). Returns the first CUDA error, or 0.
extern "C" int fused_mlp_swiglu(int layout, const void* x, const void* wg, const void* sg,
                                const void* wu, const void* su, const void* wd, const void* sd,
                                void* h, void* partial, void* out, int B, int D, int F,
                                int group_d, int group_f, int split1, int per1, int split2,
                                int per2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool int8 = layout == Q8;
  cudaError_t e = launch_gemm(false, layout, x, wg, sg, wu, su, partial, B, D, F, group_d, 2,
                              split1, per1, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  swiglu_merge_kernel<<<merge_blocks(B, F), MERGE_THREADS, 0, st>>>(
      static_cast<const float*>(partial), int8 ? static_cast<const float*>(sg) : nullptr,
      int8 ? static_cast<const float*>(su) : nullptr, static_cast<bf16*>(h), split1, B, F);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_gemm(false, layout, h, wd, sd, wd, sd, partial, B, F, D, group_f, 1, split2, per2,
                  st);
  if (e != cudaSuccess) return static_cast<int>(e);
  fused_mlp_down_merge_kernel<<<merge_blocks(B, D), MERGE_THREADS, 0, st>>>(
      static_cast<const float*>(partial), int8 ? static_cast<const float*>(sd) : nullptr,
      static_cast<float*>(out), split2, B, D);
  return static_cast<int>(cudaGetLastError());
}

// K5: out (B, N) fp32 = x (B, K) bf16 @ column-packed int4 w (K, N / 2) with
// scales s (K / group, N). partial: fp32 workspace of splits * B * N
// elements.
extern "C" int fused_mlp_matmul_int4c(const void* x, const void* w, const void* s, void* partial,
                                      void* out, int B, int K, int N, int group, int splits,
                                      int rows_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch_gemm(true, Q4C, x, w, s, w, s, partial, B, K, N, group, 1, splits,
                              rows_per_split, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  matmul_int4c_merge_kernel<<<merge_blocks(B, N), MERGE_THREADS, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), splits, B, N);
  return static_cast<int>(cudaGetLastError());
}

// K4 on the wgmma kernel (q4c::): out (B, D) fp32 = (silu(x @ Wg) * (x @ Wu))
// @ Wd over q4c matrices whose byte rows are 16-byte aligned (D and F
// multiples of 32). x (B, D) bf16; h: (B, F) bf16 workspace; partial: fp32
// workspace of max(2 * split1 * B * F, split2 * B * D) elements. splitN,
// perN, gridN: product N's reduction splits, reduction rows per split (a
// multiple of 64) and persistent CTAs. Returns the first CUDA error, or 0.
extern "C" int fused_mlp_q4c(const void* x, const void* wg, const void* sg, const void* wu,
                             const void* su, const void* wd, const void* sd, void* h,
                             void* partial, void* out, int B, int D, int F, int group_d,
                             int group_f, int split1, int per1, int grid1, int split2, int per2,
                             int grid2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int e = q4c::launch_rows(x, wg, sg, wu, su, partial, B, D, F, group_d, 2, split1, per1, grid1,
                           st);
  if (e != 0) return e;
  swiglu_merge_kernel<<<merge_blocks(B, F), MERGE_THREADS, 0, st>>>(
      static_cast<const float*>(partial), nullptr, nullptr, static_cast<bf16*>(h), split1, B, F);
  e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  e = q4c::launch_rows(h, wd, sd, wd, sd, partial, B, F, D, group_f, 1, split2, per2, grid2, st);
  if (e != 0) return e;
  fused_mlp_down_merge_kernel<<<merge_blocks(B, D), MERGE_THREADS, 0, st>>>(
      static_cast<const float*>(partial), nullptr, static_cast<float*>(out), split2, B, D);
  return static_cast<int>(cudaGetLastError());
}


// K5 on the streaming core (wo::): out (B, n) fp32 = x (B, K) bf16 @ the
// column-packed int4 w (K, n / 2) with scales s (K / group, n); layout must
// be 0 (q4c). partial: fp32 workspace of splits * B * n elements, or out
// itself at one split (the kernel then writes the result and no merge
// runs). design: N, the rows of x a unit serves (8, 16,
// 32 or 64, and 24 for q4c; 64-row blocks above 64 rows). Returns the first
// CUDA error, or 0.
extern "C" int fused_mlp_wo_matmul(int layout, const void* x, const void* w, const void* s,
                                   void* partial, void* out, int B, int K, int n, int group,
                                   int splits, int per, int grid, int design, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (layout != Q4C || (partial == out && splits != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  int e = wo::launch_design<wo::RUN>(layout, design, x, w, s, w, s, partial, nullptr, B, K, n,
                                     group, 1, splits, per, grid, st);
  if (e != 0 || partial == out) return e;
  matmul_int4c_merge_kernel<<<merge_blocks(B, n), MERGE_THREADS, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), splits, B, n);
  return static_cast<int>(cudaGetLastError());
}

// K6 and K7 on the streaming core: the SwiGLU MLP over int8 (layout 2) or
// row-packed int4 (layout 1), out (B, D) fp32 = (silu(x @ Wg) * (x @ Wu)) @
// Wd; int8's column scales are applied by the merges, q4p's group scales
// are in the partial sums. x (B, D) bf16; h: (B, F) bf16 workspace;
// partial: fp32 workspace of max(2 * split1 * B * F, split2 * B * D)
// elements; group_d / group_f as for fused_mlp_swiglu (int8: D and F);
// splitN, perN, gridN: product N's splits, byte rows a split (a multiple of
// 64) and persistent CTAs; design as above. Returns the first CUDA error,
// or 0.
extern "C" int fused_mlp_wo_swiglu(int layout, const void* x, const void* wg, const void* sg,
                                   const void* wu, const void* su, const void* wd,
                                   const void* sd, void* h, void* partial, void* out, int B,
                                   int D, int F, int group_d, int group_f, int split1, int per1,
                                   int grid1, int split2, int per2, int grid2, int design,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (layout != Q8 && layout != Q4P) return static_cast<int>(cudaErrorInvalidValue);
  const bool int8 = layout == Q8;
  int e = wo::launch_design<wo::RUN>(layout, design, x, wg, sg, wu, su, partial, nullptr, B, D,
                                     F, group_d, 2, split1, per1, grid1, st);
  if (e != 0) return e;
  swiglu_merge_kernel<<<merge_blocks(B, F), MERGE_THREADS, 0, st>>>(
      static_cast<const float*>(partial), int8 ? static_cast<const float*>(sg) : nullptr,
      int8 ? static_cast<const float*>(su) : nullptr, static_cast<bf16*>(h), split1, B, F);
  e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  e = wo::launch_design<wo::RUN>(layout, design, h, wd, sd, wd, sd, partial, nullptr, B, F, D,
                                 group_f, 1, split2, per2, grid2, st);
  if (e != 0) return e;
  fused_mlp_down_merge_kernel<<<merge_blocks(B, D), MERGE_THREADS, 0, st>>>(
      static_cast<const float*>(partial), int8 ? static_cast<const float*>(sd) : nullptr,
      static_cast<float*>(out), split2, B, D);
  return static_cast<int>(cudaGetLastError());
}

#ifdef WO_PROBE
// chip_smoke.py --phases wo_probe only (a library built with -DWO_PROBE):
// one product on the streaming core in probe mode `mode` (wo::Mode; the
// cut-down modes for the designs of 1 and 20 rows: q4c and q4p N 8 and 24,
// int8 N 8 and 32), its per-warp counters into `probe`
// (grid * 8 * wo::P_COUNT uint64).
extern "C" int wo_probe(int mode, int layout, int design, const void* x, const void* w,
                        const void* s, void* partial, void* probe, int B, int K, int n, int group,
                        int splits, int per, int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* pc = static_cast<unsigned long long*>(probe);
#define WO_MODE(M)                                                                             \
  case wo::M:                                                                                  \
    return wo::launch_design<wo::M>(layout, design, x, w, s, w, s, partial, pc, B, K, n, group, \
                                    1, splits, per, grid, st)
  switch (mode) {
    WO_MODE(RUN);
    WO_MODE(TIMED);
    WO_MODE(IDLE);
    WO_MODE(READ);
    WO_MODE(DECODE);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WO_MODE
}

// The A/B of the products' issue: one q4c product on K4's wgmma kernel
// (q4c::, weight-stationary wgmma with a full drain a slot) with `mats` 1,
// then K5's merge. splits, per and grid from q4c_schedule.
extern "C" int wo_probe_q4c_wgmma(const void* x, const void* w, const void* s, void* partial,
                                  void* out, int B, int K, int n, int group, int splits, int per,
                                  int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int e = q4c::launch_rows(x, w, s, w, s, partial, B, K, n, group, 1, splits, per, grid, st);
  if (e != 0) return e;
  matmul_int4c_merge_kernel<<<merge_blocks(B, n), MERGE_THREADS, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), splits, B, n);
  return static_cast<int>(cudaGetLastError());
}
#endif
