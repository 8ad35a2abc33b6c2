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
// Bound. At 1 to 128 rows the products do at most 2 * 128 operations per
// weight byte, below the card's ~295 per byte, so the kernels are bound by
// the bytes of the weights, each read once: 94 MB for an 8B layer's MLP in
// int4, 279 MB for the head.
//
// Design. One family: qgemm_partial_kernel computes x @ W for one tile of
// byte columns and one range of reduction rows, with the layout as a
// template parameter that says how a byte becomes values. The TPU kernels
// walk the MLP's inner dimension F on a sequential grid axis and carry the
// (B, D) sum in VMEM. Here the MLP is two launches with h kept as a (B, F)
// bf16 workspace between them (h is rounded to bf16 anyway, so nothing is
// lost), and each product's reduction rows are cut across CTAs so that the
// card's 132 SMs all stream weights: every CTA writes its fp32 partial
// result to a workspace and a small merge kernel adds the splits in a fixed
// order (no floating-point atomics: the sum's order never changes from run
// to run) and applies the epilogue (SwiGLU to bf16, or the plain sum).
//
// A CTA stages 64 reduction rows at a time: the weight bytes and the x
// columns go from device memory to registers with 16-byte loads (the next
// tile's loads are in flight while the current tile is computed on) and then
// to shared memory. The products run on the tensor cores, mma.sync m16n8k16
// with bf16 operands and fp32 accumulators; all rows share each weight tile,
// so the weights are read once whatever B is. Each thread reads a 4 x 4
// block of weight bytes (4 reduction rows, 4 byte columns) as four 32-bit
// words, which serves 8 n-tiles (the low and the high nibble of 4 byte
// columns): the reduction rows of a k-step are taken in the order
// 4t .. 4t + 3 per thread and the 8 columns of n-tile i are the byte columns
// 4n + i, both free choices since x's fragments follow the same row order
// and the results are written back to their true columns. Nibbles become
// bf16 with integer masks and one bf16 subtraction: 0x4300 | v is the bf16
// of 128 + v for v in [0, 15], and every nibble is first put into the form
// "value + 8" by one xor per word. wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

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

// d += a (16 x 16, row) * b (16 x 8, col), fp32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte I of a and byte I of b, each a nibble value v + 8 in [0, 15], as the
// bf16 pair (v_a, v_b): a in the low half.
template <int I>
__device__ __forceinline__ uint32_t nibble_pair(uint32_t a, uint32_t b) {
  constexpr uint32_t sel = I | (I << 4) | ((4 + I) << 8) | (I << 12);
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
  b[I][0] = nibble_pair<I>(lo[0], lo[1]);                  \
  b[I][1] = nibble_pair<I>(lo[2], lo[3]);                  \
  b[(NT - 4) + I][0] = nibble_pair<I>(hi[0], hi[1]);       \
  b[(NT - 4) + I][1] = nibble_pair<I>(hi[2], hi[3]);
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
