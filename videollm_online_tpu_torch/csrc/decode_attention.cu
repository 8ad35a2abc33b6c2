// K1: ring decode attention over the stacked KV ring, for Hopper (sm_90a).
//
// Replaces the TPU kernel videollm_online_tpu/ops/decode_attention.py
// (ring_decode_attention_layered / _kernel_layered, and
// ring_decode_attention / _kernel, which is the same function over an
// L = 1 view of the ring).
//
// What it computes. q (B, Hq, S, d) attends the ring k_all/v_all
// (L, B, Hkv, C, d) at a run-time layer. The G = Hq / Hkv query heads of one
// kv head share its K/V, so they are folded into rows = G * S query rows
// (row r is head h * G + r / S, query r % S). Slot j is visible to a row iff
// j <= q_pos and, with a window, j > q_pos - window. Softmax is online in
// fp32. With int8 K/V the per-slot fp32 scales multiply the logits (K) and
// the probabilities (V); no dequantized tile is ever formed. Probabilities
// are rounded to q's dtype before P.V, as the TPU kernel rounds them. A row
// with nothing visible outputs 0.
//
// Bound. Decode attention moves far more bytes than it does arithmetic: per
// layer it must read 2 * Hkv * valid * d * sizeof(kv) bytes of K/V (plus
// 2 * Hkv * valid * 4 bytes of scales for int8 K/V), and does
// 4 * Hq * S * valid * d flops. At S <= 64 that is far below the card's
// ~295 flops per byte, so the kernel is bound by bytes. Tiles past the last
// visible slot, and tiles wholly below the window, are never read: the
// traffic is O(valid), not O(C).
//
// The 8-program problem. The TPU grid is (B, Hkv, kv blocks) with the kv
// axis run in order, so at B = 1 only B * Hkv = 8 programs run in parallel.
// Here the visible block range of each stream is split evenly across
// `nsplit` CTAs (flash-decoding); the wrapper sizes nsplit to fill the
// card's SMs several times over. Each CTA computes its range from q_pos on
// the device, so no host sync is needed to size the split; a CTA whose
// range is empty writes an empty partial and exits. A CTA streams its K/V
// tiles with 16-byte coalesced loads, holding the next tile in registers
// while it computes on the current one in shared memory, and writes a
// partial (m, l, acc) to fp32 scratch. A second small kernel merges the
// partials of each row, all splits' loads in flight at once. Plain FMA in
// this version: mma/wgmma and TMA pipelines are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int BK = 32;              // ring slots per tile (one per lane)
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

// Rounds a probability to q's dtype before P.V, as the TPU kernel does.
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
// loads are in flight while the current one is computed on.
template <typename T, int D, int ROWS>
struct Tile {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int PER_ROW = D / VEC;
  static constexpr int N = ROWS * PER_ROW / THREADS;  // chunks per thread
  static_assert(N >= 1 && ROWS * PER_ROW % THREADS == 0, "tile shape");
  uint4 reg[N];

  __device__ __forceinline__ void load(const T* src, int valid) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int idx = threadIdx.x + k * THREADS;
      const int r = idx / PER_ROW;
      const int c = (idx % PER_ROW) * VEC;
      reg[k] = r < valid ? __ldg(reinterpret_cast<const uint4*>(src + r * D + c))
                         : make_uint4(0u, 0u, 0u, 0u);
    }
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

template <int D>
constexpr size_t split_smem_bytes() {
  return (BK * (D + 1) + BK * D + R * D + R * BK + 2 * BK) * sizeof(float);
}

// grid (nsplit, B * Hkv, ceil(rows / R)); one CTA = one split of the
// visible range x one kv head x R query rows.
template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(THREADS)
k1_split_kernel(const QT* __restrict__ q, const KT* __restrict__ k_all,
                const KT* __restrict__ v_all, const float* __restrict__ k_scale,
                const float* __restrict__ v_scale, const int* __restrict__ q_pos,
                float* __restrict__ part_acc, float* __restrict__ part_ml,
                int B, int Hkv, int S, int rows, int C, int layer, int window,
                int nsplit) {
  constexpr bool QUANT = std::is_same<KT, int8_t>::value;
  constexpr int CPL = D / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* sK = smem;                  // BK x (D + 1): padded, lane j reads row j
  float* sV = sK + BK * (D + 1);     // BK x D
  float* sQ = sV + BK * D;           // R x D
  float* sP = sQ + R * D;            // R x BK
  float* sKs = sP + R * BK;          // BK
  float* sVs = sKs + BK;             // BK
  __shared__ int s_range[2];

  const int split = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / Hkv;
  const int row0 = blockIdx.z * R;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int valid_rows = min(R, rows - row0);
  const size_t pbase = (static_cast<size_t>(split) * gridDim.y + bh) * rows + row0;

  if (threadIdx.x == 0) {
    // this stream's visible tiles [fb, nb), split evenly over nsplit CTAs
    int mx = INT_MIN, mn = INT_MAX;
    for (int s = 0; s < S; ++s) {
      const int p = q_pos[b * S + s];
      mx = max(mx, p);
      mn = min(mn, p);
    }
    const int n_cap = (C + BK - 1) / BK;
    const int nb = mx < 0 ? 0 : min(mx / BK + 1, n_cap);
    int fb = 0;
    if (window > 0) {
      const int lo = mn - window + 1;
      fb = lo > 0 ? lo / BK : 0;
    }
    const int n = max(nb - fb, 0);
    const int per = (n + nsplit - 1) / nsplit;
    const int start = fb + split * per;
    const int end = min(nb, start + per);
    s_range[0] = start;
    s_range[1] = max(end, start);
  }
  __syncthreads();
  const int start = s_range[0];
  const int end = s_range[1];
  if (start == end) {  // nothing of this stream falls in this split
    for (int i = threadIdx.x; i < valid_rows; i += THREADS) {
      part_ml[(pbase + i) * 2] = NEG;
      part_ml[(pbase + i) * 2 + 1] = 0.f;
    }
    return;
  }

  const size_t head = (static_cast<size_t>(layer) * B * Hkv + bh) * C;
  Tile<KT, D, BK> kt, vt;
  float ks_reg = 0.f, vs_reg = 0.f;
  auto prefetch = [&](int blk) {
    const int slot0 = blk * BK;
    const int nvalid = min(BK, C - slot0);
    kt.load(k_all + (head + slot0) * D, nvalid);
    vt.load(v_all + (head + slot0) * D, nvalid);
    if (QUANT && threadIdx.x < BK) {
      const bool ok = threadIdx.x < nvalid;
      ks_reg = ok ? k_scale[head + slot0 + threadIdx.x] : 0.f;
      vs_reg = ok ? v_scale[head + slot0 + threadIdx.x] : 0.f;
    }
  };
  prefetch(start);

  {  // q rows of this CTA, fp32 in shared memory; rows past the end are 0
    Tile<QT, D, R> qt;
    qt.load(q + (static_cast<size_t>(bh) * rows + row0) * D, valid_rows);
    qt.store(sQ, D);
  }

  const bool warp_active = warp * RPW < valid_rows;
  int qp[RPW];
  bool row_ok[RPW];
  float m[RPW], l[RPW], acc[RPW][CPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = row0 + warp * RPW + i;
    row_ok[i] = r < rows;
    qp[i] = row_ok[i] ? q_pos[b * S + r % S] : 0;
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[i][c] = 0.f;
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(D));

  for (int blk = start; blk < end; ++blk) {
    const int slot0 = blk * BK;
    __syncthreads();  // every warp is done with the previous tile
    kt.store(sK, D + 1);
    vt.store(sV, D);
    if (QUANT && threadIdx.x < BK) {
      sKs[threadIdx.x] = ks_reg;
      sVs[threadIdx.x] = vs_reg;
    }
    __syncthreads();
    if (blk + 1 < end) prefetch(blk + 1);  // in flight during the compute
    if (!warp_active) continue;

    // logits: lane j scores slot slot0 + j against this warp's RPW rows
    float sc[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) sc[i] = 0.f;
    const float* krow = sK + lane * (D + 1);
    const float* qrows = sQ + warp * RPW * D;
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
      const bool vis = row_ok[i] && slot < C && slot <= qp[i] &&
                       (window <= 0 || slot > qp[i] - window);
      s = vis ? s : NEG;
      const float m_new = fmaxf(m[i], warp_max(s));
      const float p = vis ? expf(s - m_new) : 0.f;
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(p);
      m[i] = m_new;
      sP[(warp * RPW + i) * BK + lane] = round_like<QT>(QUANT ? p * sVs[lane] : p);
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();

    // acc += P V: lane owns columns lane + 32 * c of its warp's rows
    const float* prows = sP + warp * RPW * BK;
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

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp * RPW + i;
    if (r >= valid_rows) continue;
    float* pa = part_acc + (pbase + r) * D;
#pragma unroll
    for (int c = 0; c < CPL; ++c) pa[lane + 32 * c] = acc[i][c];
    if (lane == 0) {
      part_ml[(pbase + r) * 2] = m[i];
      part_ml[(pbase + r) * 2 + 1] = l[i];
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

// grid (B * Hkv, rows), D threads: merges the nsplit partials of one row.
// The split weights exp(m_s - max m) go to shared memory first, so the
// acc loads of all splits are independent and in flight together.
template <typename QT, int D>
__global__ void __launch_bounds__(D)
k1_merge_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
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

template <typename QT, typename KT, int D>
int launch(const void* q, const void* k_all, const void* v_all, const void* k_scale,
           const void* v_scale, const void* q_pos, void* out, void* part_acc, void* part_ml,
           int B, int Hkv, int S, int rows, int C, int layer, int window, int nsplit,
           cudaStream_t stream) {
  constexpr size_t smem = split_smem_bytes<D>();
  auto kern = k1_split_kernel<QT, KT, D>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(nsplit, B * Hkv, (rows + R - 1) / R);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_all), static_cast<const KT*>(v_all),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(q_pos), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), B, Hkv, S, rows, C, layer, window, nsplit);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  k1_merge_kernel<QT, D><<<dim3(B * Hkv, rows), D, nsplit * sizeof(float), stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<QT*>(out), rows, nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT>
int launch_d(int d, const void* q, const void* k_all, const void* v_all, const void* k_scale,
             const void* v_scale, const void* q_pos, void* out, void* part_acc, void* part_ml,
             int B, int Hkv, int S, int rows, int C, int layer, int window, int nsplit,
             cudaStream_t stream) {
#define K1_LAUNCH(DD)                                                                    \
  return launch<QT, KT, DD>(q, k_all, v_all, k_scale, v_scale, q_pos, out, part_acc,    \
                            part_ml, B, Hkv, S, rows, C, layer, window, nsplit, stream)
  switch (d) {
    case 64: K1_LAUNCH(64);
    case 128: K1_LAUNCH(128);
    case 256: K1_LAUNCH(256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K1_LAUNCH
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16. kv_int8: 0 = K/V have q's dtype,
// 1 = int8 codes with fp32 (L, B, Hkv, C) scales. window <= 0: no window.
// part_acc: fp32 (nsplit, B * Hkv, rows, d); part_ml: fp32 (nsplit, B * Hkv,
// rows, 2). Returns cudaGetLastError() after both launches.
extern "C" int k1_ring_decode_attention(
    const void* q, const void* k_all, const void* v_all, const void* k_scale,
    const void* v_scale, const void* q_pos, void* out, void* part_acc, void* part_ml,
    int B, int Hkv, int S, int rows, int d, int C, int layer, int window, int nsplit,
    int q_dtype, int kv_int8, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 1) {
    if (kv_int8)
      return launch_d<__nv_bfloat16, int8_t>(d, q, k_all, v_all, k_scale, v_scale, q_pos, out,
                                             part_acc, part_ml, B, Hkv, S, rows, C, layer,
                                             window, nsplit, st);
    return launch_d<__nv_bfloat16, __nv_bfloat16>(d, q, k_all, v_all, k_scale, v_scale, q_pos,
                                                  out, part_acc, part_ml, B, Hkv, S, rows, C,
                                                  layer, window, nsplit, st);
  }
  if (kv_int8)
    return launch_d<float, int8_t>(d, q, k_all, v_all, k_scale, v_scale, q_pos, out, part_acc,
                                   part_ml, B, Hkv, S, rows, C, layer, window, nsplit, st);
  return launch_d<float, float>(d, q, k_all, v_all, k_scale, v_scale, q_pos, out, part_acc,
                                part_ml, B, Hkv, S, rows, C, layer, window, nsplit, st);
}
