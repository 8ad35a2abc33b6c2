// Shared machinery of the split-KV decode attention kernels for Hopper
// (sm_90a): K1 (decode_attention.cu, the stacked KV ring) and K3
// (paged_attention.cu, the paged pool). The two differ only in where a
// slot's K/V row lives and in how a CTA finds its visible range; the tiles,
// the per-tile online softmax and P.V, and the merge of the split partials
// are written once here.
//
// Layout of one split CTA: WARPS warps, each holding RPW query rows, so a
// CTA covers R = WARPS * RPW rows of one (stream, kv head); K/V stream in
// tiles of BK slots, one slot per lane. Plain fp32 FMA: mma/wgmma tiles are
// later work and land here for both kernels.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BK = 32;              // slots per tile (one per lane)
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = 4;              // query rows per warp
constexpr int R = WARPS * RPW;      // query rows per CTA
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Rounds a probability to q's dtype before P.V, as the TPU kernels do.
template <typename QT>
__device__ __forceinline__ float round_like(float x) {
  if constexpr (std::is_same<QT, __nv_bfloat16>::value) return __bfloat162float(__float2bfloat16(x));
  return x;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One (ROWS, D) tile of T, loaded 16 bytes per thread per chunk into
// registers and stored to fp32 shared memory later, so that the next tile's
// loads are in flight while the current one is computed on. Rows at or past
// `valid` are zero and not read.
template <typename T, int D, int ROWS>
struct Tile {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int PER_ROW = D / VEC;
  static constexpr int N = ROWS * PER_ROW / THREADS;  // chunks per thread
  static_assert(N >= 1 && ROWS * PER_ROW % THREADS == 0, "tile shape");
  uint4 reg[N];

  // tile row r is row row_of(r) of src, counted in rows of D elements
  template <typename RowOf>
  __device__ __forceinline__ void load_rows(const T* src, RowOf row_of, int valid) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int idx = threadIdx.x + k * THREADS;
      const int r = idx / PER_ROW;
      const int c = (idx % PER_ROW) * VEC;
      reg[k] = r < valid ? __ldg(reinterpret_cast<const uint4*>(src + row_of(r) * D + c))
                         : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // contiguous rows
  __device__ __forceinline__ void load(const T* src, int valid) {
    load_rows(src, [](int r) { return static_cast<size_t>(r); }, valid);
  }

  __device__ __forceinline__ void store(float* dst, int ld) const {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int idx = threadIdx.x + k * THREADS;
      const T* e = reinterpret_cast<const T*>(&reg[k]);
      float* o = dst + (idx / PER_ROW) * ld + (idx % PER_ROW) * VEC;
#pragma unroll
      for (int i = 0; i < VEC; ++i) o[i] = to_f(e[i]);
    }
  }
};

// Shared memory of one split CTA, in floats:
//   sK  BK x (D + 1)  padded, lane j reads row j
//   sV  BK x D
//   sQ  R x D
//   sP  R x BK
//   sKs, sVs  BK each (int8 K/V scales)
template <int D>
constexpr size_t split_smem_bytes() {
  return (BK * (D + 1) + BK * D + R * D + R * BK + 2 * BK) * sizeof(float);
}

// One warp's online-softmax update over the tile of slots slot0 .. slot0 +
// BK - 1 that sits in shared memory: logits of its RPW rows against the
// tile (the K scale folded in), the visibility mask (slot < limit, slot <=
// q_pos and, with window > 0, slot > q_pos - window), the running max and
// sum, and acc += P V with the V scale folded into P and P rounded to q's
// dtype. Lane j scores slot slot0 + j; lane c owns output columns c + 32 i.
template <typename QT, bool QUANT, int D>
__device__ __forceinline__ void tile_update(const float* sK, const float* sV, const float* qrows,
                                            float* prows, const float* sKs, const float* sVs,
                                            int lane, int slot0, int limit, int window,
                                            const int (&qp)[RPW], const bool (&row_ok)[RPW],
                                            float (&m)[RPW], float (&l)[RPW],
                                            float (&acc)[RPW][D / 32]) {
  constexpr int CPL = D / 32;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  float sc[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) sc[i] = 0.f;
  const float* krow = sK + lane * (D + 1);
#pragma unroll 8
  for (int c = 0; c < D; ++c) {
    const float kv = krow[c];
#pragma unroll
    for (int i = 0; i < RPW; ++i) sc[i] = fmaf(qrows[i * D + c], kv, sc[i]);
  }
  const int slot = slot0 + lane;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    float s = sc[i] * scale;
    if (QUANT) s *= sKs[lane];
    const bool vis = row_ok[i] && slot < limit && slot <= qp[i] &&
                     (window <= 0 || slot > qp[i] - window);
    s = vis ? s : NEG;
    const float m_new = fmaxf(m[i], warp_max(s));
    const float p = vis ? expf(s - m_new) : 0.f;
    const float alpha = expf(m[i] - m_new);
    l[i] = l[i] * alpha + warp_sum(p);
    m[i] = m_new;
    prows[i * BK + lane] = round_like<QT>(QUANT ? p * sVs[lane] : p);
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[i][c] *= alpha;
  }
  __syncwarp();

#pragma unroll 4
  for (int j = 0; j < BK; ++j) {
    float vr[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) vr[c] = sV[j * D + lane + 32 * c];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const float p = prows[i * BK + j];
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[i][c] = fmaf(p, vr[c], acc[i][c]);
    }
  }
}

// Max (or sum) over the block; every thread gets the result.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* s_red) {
  v = MAX ? warp_max(v) : warp_sum(v);
  if (threadIdx.x % 32 == 0) s_red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = s_red[0];
  for (int i = 1; i < blockDim.x / 32; ++i) t = MAX ? fmaxf(t, s_red[i]) : t + s_red[i];
  __syncthreads();
  return t;
}

// grid (B * Hkv, rows), D threads: merges the nsplit partials (fp32 acc of
// (nsplit, B * Hkv, rows, D), (m, l) of (nsplit, B * Hkv, rows, 2)) of one
// row into out. The split weights exp(m_s - max m) go to shared memory
// first, so the acc loads of all splits are independent and in flight
// together. A row whose every split is empty outputs 0.
template <typename QT, int D>
__global__ void __launch_bounds__(D)
merge_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
             QT* __restrict__ out, int rows, int nsplit) {
  extern __shared__ float s_w[];  // nsplit
  __shared__ float s_red[D / 32];
  const int bh = blockIdx.x;
  const int r = blockIdx.y;
  const int c = threadIdx.x;
  const size_t nbh = gridDim.x;
  float mx = NEG;
  for (int s = c; s < nsplit; s += D) {
    const size_t i = (s * nbh + bh) * rows + r;
    if (part_ml[i * 2 + 1] > 0.f) mx = fmaxf(mx, part_ml[i * 2]);
  }
  mx = block_reduce<true>(mx, s_red);
  float lsum = 0.f;
  for (int s = c; s < nsplit; s += D) {
    const size_t i = (s * nbh + bh) * rows + r;
    const float li = part_ml[i * 2 + 1];
    const float w = li > 0.f ? expf(part_ml[i * 2] - mx) : 0.f;
    s_w[s] = w;
    lsum += li * w;
  }
  lsum = block_reduce<false>(lsum, s_red);  // its barrier publishes s_w
  float a = 0.f;
#pragma unroll 8
  for (int s = 0; s < nsplit; ++s) {
    const float w = s_w[s];
    if (w != 0.f) a = fmaf(part_acc[((s * nbh + bh) * rows + r) * D + c], w, a);
  }
  from_f(out + (static_cast<size_t>(bh) * rows + r) * D + c, lsum > 0.f ? a / lsum : 0.f);
}

template <typename QT, int D>
int launch_merge(const void* part_acc, const void* part_ml, void* out, int BH, int rows,
                 int nsplit, cudaStream_t stream) {
  merge_kernel<QT, D><<<dim3(BH, rows), D, nsplit * sizeof(float), stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<QT*>(out), rows, nsplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
