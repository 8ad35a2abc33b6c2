// Shared machinery of the split-KV decode attention kernels for Hopper
// (sm_90a): K1 (decode_attention.cu, the stacked KV ring) and K3
// (paged_attention.cu, the paged pool). The two differ only in where a
// slot's K/V row lives, which each file states as a Pool type (Pool::
// stream(b, h).at(slot) is the pool row of a slot); the visible range, the
// tiles, the online softmax and P.V, the merge of the split partials and
// the launches are written once here, in two designs that the wrapper
// picks by (dtype, d) (ops/decode_attention.py: kernel_design):
//
//  * fma (fp32 q, whose accumulation bf16 tensor cores cannot hold, and
//    d = 256, whose accumulators do not fit a warp's registers): WARPS
//    warps of RPW query rows, so a CTA covers R = 16 rows of one (stream,
//    kv head); K/V stream in tiles of BK = 32 slots, one slot per lane,
//    staged as fp32; plain FMA; the split partials merge in a second
//    launch (decode_merge_kernel).
//  * tensor cores (namespace tc: bf16 q, d in {64, 128}, bf16 or int8 K/V,
//    every main path). See the comment there.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "mma_sync.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BK = 32;              // slots per tile (one per lane)
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = 4;              // query rows per warp
constexpr int R = WARPS * RPW;      // query rows per CTA
constexpr float NEG = -1e30f;

// What a launch needs besides the pool: kv heads, queries per stream, the
// G * S query rows of a kv head, the window (<= 0: none) and the splits.
struct Args {
  int Hkv, S, rows, window, nsplit;
};

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
// loads are in flight while the current one is computed on. Rows below
// `first` or at or past `valid` are zero and not read.
template <typename T, int D, int ROWS>
struct Tile {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int PER_ROW = D / VEC;
  static constexpr int N = ROWS * PER_ROW / THREADS;  // chunks per thread
  static_assert(N >= 1 && ROWS * PER_ROW % THREADS == 0, "tile shape");
  uint4 reg[N];

  // tile row r is row row_of(r) of src, counted in rows of D elements
  template <typename RowOf>
  __device__ __forceinline__ void load_rows(const T* src, RowOf row_of, int first, int valid) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int idx = threadIdx.x + k * THREADS;
      const int r = idx / PER_ROW;
      const int c = (idx % PER_ROW) * VEC;
      reg[k] = r >= first && r < valid
                   ? __ldg(reinterpret_cast<const uint4*>(src + row_of(r) * D + c))
                   : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // contiguous rows
  __device__ __forceinline__ void load(const T* src, int valid) {
    load_rows(src, [](int r) { return static_cast<size_t>(r); }, 0, valid);
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
decode_merge_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
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
  decode_merge_kernel<QT, D><<<dim3(BH, rows), D, nsplit * sizeof(float), stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<QT*>(out), rows, nsplit);
  return static_cast<int>(cudaGetLastError());
}

// This stream's visible slots [lo, hi] (hi < lo: none) from its S query
// positions, and this split's tiles [start, start + n) of BK_ slots: the
// visible tiles cut into nsplit runs of equal length (the last ones shorter
// or empty). ops/decode_attention.py split_ranges mirrors it.
struct Range {
  int lo, hi, start, n;
};

template <int BK_>
__device__ __forceinline__ Range split_range(int mn, int mx, int slots, int window, int split,
                                             int nsplit) {
  Range r{window > 0 ? max(mn - window + 1, 0) : 0, min(mx, slots - 1), 0, 0};
  if (r.hi >= 0 && r.lo <= r.hi) {
    const int fb = r.lo / BK_, nb = r.hi / BK_ + 1;
    const int per = (nb - fb + nsplit - 1) / nsplit;
    r.start = fb + split * per;
    r.n = max(min(nb, r.start + per) - r.start, 0);
  }
  return r;
}

// The FMA design. grid (nsplit, B * Hkv, ceil(rows / R)); one CTA = one
// split of a stream's visible tiles x one kv head x R query rows. Rows of
// a tile outside [lo, hi] load as zeros and are never read.
template <class Pool, typename QT, typename KT, int D>
__global__ void __launch_bounds__(THREADS)
fma_split_kernel(const QT* __restrict__ q, const KT* __restrict__ kp,
                 const KT* __restrict__ vp, const float* __restrict__ ks,
                 const float* __restrict__ vs, const int* __restrict__ q_pos,
                 float* __restrict__ part_acc, float* __restrict__ part_ml, Pool pool, Args a) {
  constexpr bool QUANT = std::is_same<KT, int8_t>::value;
  constexpr int CPL = D / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* sK = smem;                  // BK x (D + 1): padded, lane j reads row j
  float* sV = sK + BK * (D + 1);     // BK x D
  float* sQ = sV + BK * D;           // R x D
  float* sP = sQ + R * D;            // R x BK
  float* sKs = sP + R * BK;          // BK
  float* sVs = sKs + BK;             // BK
  __shared__ Range s_range;

  const int split = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / a.Hkv;
  const int row0 = blockIdx.z * R;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rows = a.rows;
  const int valid_rows = min(R, rows - row0);
  const size_t pbase = (static_cast<size_t>(split) * gridDim.y + bh) * rows + row0;

  if (threadIdx.x == 0) {
    int mx = INT_MIN, mn = INT_MAX;
    for (int s = 0; s < a.S; ++s) {
      const int p = q_pos[b * a.S + s];
      mx = max(mx, p);
      mn = min(mn, p);
    }
    s_range = split_range<BK>(mn, mx, pool.slots(), a.window, split, a.nsplit);
  }
  __syncthreads();
  const Range rg = s_range;
  if (rg.n == 0) {  // nothing of this stream falls in this split
    for (int i = threadIdx.x; i < valid_rows; i += THREADS) {
      part_ml[(pbase + i) * 2] = NEG;
      part_ml[(pbase + i) * 2 + 1] = 0.f;
    }
    return;
  }

  const auto src = pool.stream(b, bh % a.Hkv);
  Tile<KT, D, BK> kt, vt;
  float ks_reg = 0.f, vs_reg = 0.f;
  auto prefetch = [&](int blk) {
    const int slot0 = blk * BK;
    const int nvalid = min(BK, rg.hi + 1 - slot0);
    const int first = max(rg.lo - slot0, 0);
    const auto row_of = [&](int r) { return src.at(slot0 + r); };
    kt.load_rows(kp, row_of, first, nvalid);
    vt.load_rows(vp, row_of, first, nvalid);
    if (QUANT && threadIdx.x < BK) {
      const bool ok = threadIdx.x >= first && threadIdx.x < nvalid;
      const size_t i = ok ? src.at(slot0 + threadIdx.x) : 0;
      ks_reg = ok ? ks[i] : 0.f;
      vs_reg = ok ? vs[i] : 0.f;
    }
  };
  prefetch(rg.start);

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
    qp[i] = row_ok[i] ? q_pos[b * a.S + r % a.S] : 0;
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[i][c] = 0.f;
  }
  const int end = rg.start + rg.n;
  for (int blk = rg.start; blk < end; ++blk) {
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
    tile_update<QT, QUANT, D>(sK, sV, sQ + warp * RPW * D, sP + warp * RPW * BK, sKs, sVs, lane,
                              blk * BK, rg.hi + 1, a.window, qp, row_ok, m, l, acc);
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

template <class Pool, typename QT, typename KT, int D>
int launch_fma(const void* q, const void* k, const void* v, const void* ks, const void* vs,
               const void* q_pos, void* out, void* part_acc, void* part_ml, int B,
               const Pool& pool, const Args& a, cudaStream_t stream) {
  constexpr size_t smem = split_smem_bytes<D>();
  auto kern = fma_split_kernel<Pool, QT, KT, D>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(a.nsplit, B * a.Hkv, (a.rows + R - 1) / R);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(q_pos), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), pool, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_merge<QT, D>(part_acc, part_ml, out, B * a.Hkv, a.rows, a.nsplit, stream);
}


// ---------------------------------------------------------------------------
// The tensor-core design: bf16 q with d in {64, 128}, over bf16 or int8 K/V.
//
// Bound. A call must read each visible slot's K and V once and does 4 * d
// FLOPs per (query row, visible slot). At S = 1 and 20 that is far below the
// card's ~295 FLOPs a byte (bytes bound it); at S = 91 and 128 over bf16 K/V
// (364 and 512 rows a kv head) operations do. So the design keeps many
// bytes in flight when rows are few and the tensor cores fed when rows are
// many, and it reads each K/V tile into shared memory once for as many
// rows as it can.
//
// One tile. K/V stream through a ring of STAGES tiles of BK = 64 slots,
// loaded with cp.async 16 bytes a lane, so that loads stay in flight while
// the warps compute. A tile is stored in the 128-byte swizzle (wgmma.cuh),
// which wgmma reads as its B operand and ldmatrix reads without bank
// conflicts. Every slot row is looked up through the Pool (K3: one
// page-table lookup a row, or one a tile when page % 64 == 0), so pages
// smaller than a tile and tiles that straddle pages work. Rows outside the
// stream's visible slots [lo, hi] are zero-filled by the copy and never
// read: junk past a stream's last slot or below its window (the trash page,
// bucket padding, freed pages) never enters a product.
//
// Rows, two engines on that tile. The G * S query rows of a kv head are cut
// into row blocks. Each warp owns 16 rows and loads their Q fragments into
// registers once.
//  * Many rows (G * S > 16; WS = 1): two warpgroups (8 warps, 128 rows) run
//    wgmma: S = Q K^T as m64n64k16 with Q from registers and K-major K, then
//    O += P V as m64n{d}k16 with P from registers and V read MN-major. The
//    tensor cores take K and V straight from shared memory, once per 64
//    rows, where mma.sync loads every B fragment into each warp's registers
//    through ldmatrix; at these sizes the time goes to instructions issued
//    per tile, not to the products, so the fewer the better. A CTA of 128
//    rows also reads each tile through L2 half as often as one of 64.
//  * Few rows (G * S <= 16; WS = 4): one m16 tile holds every row, so 4
//    warps take 4 slices of each tile's slots and merge their (m, l, acc)
//    through shared memory at the end; mma.sync m16n8k16 with K through
//    ldmatrix and V through ldmatrix.trans. Here bytes in flight set the
//    pace, and no warp idles.
// The row count picks the engine (ops/decode_attention.py row_blocks), as
// measured on the H100 at the main paths' chunk lengths (chip_smoke.py
// --phases tc_configs): at 4 and 16 rows the sliced mma.sync CTAs beat
// wgmma on the 8-stream pool by a fifth and trail it on one stream by a
// tenth; from 80 rows up wgmma is as fast or faster (1.6 to 1.8 times at
// 364 and 512 rows).
// P stays in registers as the A operand of P V (c_to_a / the wgmma A
// layout, which is the same), rounded to bf16 as the TPU kernel rounds it.
// The softmax runs in log2 units: bf16 logits take scale * log2(e) inside
// the exponent's fma; an O rescale is skipped when no row's max moved.
//
// Addresses. Each thread moves fixed chunks of every tile (the same rows
// and columns), so a tile that lies in consecutive pool rows costs one
// base address and no per-chunk arithmetic: computing every chunk's row,
// slot check and swizzle anew takes more issue slots than the tile's
// products, and measured as the kernel's limit.
//
// int8 K/V. Codes are exact in bf16. Each int8 tile lands in the ring as it
// is stored and is converted once into a swizzled bf16 tile by the whole
// CTA (every warp reads all of it, so converting per fragment would repeat
// the work in each warp; wgmma reads its B operand from shared memory), then
// read like a bf16 tile. The K scale multiplies each column of S; the V
// scale folds into P before the bf16 rounding, as the TPU kernel does.
//
// Splits. A stream's visible tiles are split evenly over nsplit CTAs
// (flash-decoding), found from q_pos on the device. With nsplit = 1 a CTA
// writes its output directly. Otherwise it writes an fp32 partial (m, l,
// acc) and decode_merge_kernel merges them in a second launch, spread over (head,
// row) blocks, in split order, so the bits are equal run to run. (Merging
// in the split kernel instead, in the last CTA of a (head, row block) to
// finish, by an atomic ticket, saves the launch but leaves the whole merge
// to one CTA: it measured slower at every main-path shape.)
namespace tc {

constexpr int BK = 64;  // slots per tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// One configuration of the kernel: WS slices of each tile per row block.
template <typename KT, int D, int WS>
struct Cfg {
  static constexpr bool WGMMA = WS == 1;
  static constexpr bool QUANT = std::is_same<KT, int8_t>::value;
  static constexpr int WARPS = WGMMA ? 8 : 4;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int RB = 16 * WARPS / WS;   // query rows per CTA: 128 or 16
  static constexpr int STAGES = 3;              // tiles in the ring
  static constexpr int MIN_CTAS = WGMMA ? 1 : 2;
  static constexpr int TILE_B = BK * D * 2;     // a swizzled bf16 K or V tile
  static constexpr int LD8 = D + 16;            // int8 ring row stride, bytes
  static constexpr int TILE = QUANT ? BK * LD8 : TILE_B;
  static constexpr int STAGE = 2 * TILE + (QUANT ? 2 * BK * 4 : 0);  // K, V (, scales)
  static constexpr int CONV_OFF = (STAGES * STAGE + 1023) / 1024 * 1024;  // int8: bf16 K, V
  static constexpr int RING = CONV_OFF + (QUANT ? 2 * TILE_B : 0);
  static constexpr int LDO = D + 8;             // epilogue fp32 row stride
  static constexpr int EPI = WARPS * 16 * LDO * 4 + 2 * WARPS * 16 * 4 + RB * (WS + 2) * 4;
  static constexpr int SMEM = (RING > EPI ? RING : EPI) + 1024;  // + alignment to 1024
};

// Makes this thread's shared-memory writes (cp.async, st.shared) visible
// to wgmma, which reads through the async proxy.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Two int8 codes (bytes 2 * half and 2 * half + 1 of w) as a bf16 pair,
// exactly: 2^23 + (code + 128) as an fp32 bit pattern, less 2^23 + 128.
__device__ __forceinline__ uint32_t i8x2_bf16(uint32_t w, int half) {
  const uint32_t u = w ^ 0x80808080u;
  const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | (2 * half))) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541 | (2 * half))) - 8388736.f;
  return pack_bf16(lo, hi);
}

// A BK x D int8 tile (row stride ld bytes) into a swizzled bf16 tile, 16
// codes a thread per step.
template <int D, int THREADS>
__device__ __forceinline__ void convert_tile(unsigned char* dst, const int8_t* src, int ld) {
  constexpr int CPR = D / 16;
  for (int idx = threadIdx.x; idx < BK * CPR; idx += THREADS) {
    const int r = idx / CPR, c = (idx % CPR) * 16;
    const uint4 w = *reinterpret_cast<const uint4*>(src + r * ld + c);
    *reinterpret_cast<uint4*>(dst + swizzled(BK, r, c)) = make_uint4(
        i8x2_bf16(w.x, 0), i8x2_bf16(w.x, 1), i8x2_bf16(w.y, 0), i8x2_bf16(w.y, 1));
    *reinterpret_cast<uint4*>(dst + swizzled(BK, r, c + 8)) = make_uint4(
        i8x2_bf16(w.z, 0), i8x2_bf16(w.z, 1), i8x2_bf16(w.w, 0), i8x2_bf16(w.w, 1));
  }
}

__device__ __forceinline__ int warp_imin(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_imax(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// grid (ceil(rows / RB), nsplit, B * Hkv); one CTA = RB query rows x one
// split of a stream's visible tiles x one kv head. The row blocks of a
// (split, head) are neighbours in launch order, so they run together and
// read each K/V tile from L2 after the first.
template <class Pool, typename KT, int D, int WS>
__global__ void __launch_bounds__(Cfg<KT, D, WS>::THREADS, Cfg<KT, D, WS>::MIN_CTAS)
    decode_tc_kernel(const bf16* __restrict__ q, const KT* __restrict__ kp,
                     const KT* __restrict__ vp, const float* __restrict__ ks,
                     const float* __restrict__ vs, const int* __restrict__ q_pos,
                     bf16* __restrict__ out, float* __restrict__ part_acc,
                     float* __restrict__ part_ml, Pool pool, Args a) {
  using C = Cfg<KT, D, WS>;
  constexpr bool QUANT = C::QUANT;
  constexpr int WARPS = C::WARPS, THREADS = C::THREADS, RB = C::RB, STAGES = C::STAGES;
  constexpr int NS = BK / WS;  // slots of a tile per warp
  constexpr int NT = NS / 8;   // n-tiles of S per warp
  constexpr int DT = D / 8;    // n-tiles of O
  constexpr int KS = D / 16;   // k-steps of Q K^T
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __shared__ int s_red[2 * WARPS];

  const int split = blockIdx.y, bh = blockIdx.z;
  const int b = bh / a.Hkv, h = bh % a.Hkv;
  const int rows = a.rows, row0 = blockIdx.x * RB;
  const int valid_rows = min(RB, rows - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = warp / WS, ws = warp % WS;

  // this stream's visible slots [lo, hi] from its S query positions, and
  // this split's tiles [start, start + n)
  int mn = INT_MAX, mx = INT_MIN;
  for (int s = threadIdx.x; s < a.S; s += THREADS) {
    const int p = q_pos[b * a.S + s];
    mn = min(mn, p);
    mx = max(mx, p);
  }
  mn = warp_imin(mn);
  mx = warp_imax(mx);
  if (lane == 0) {
    s_red[warp] = mn;
    s_red[WARPS + warp] = mx;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    mn = min(mn, s_red[w]);
    mx = max(mx, s_red[WARPS + w]);
  }
  const Range rg = split_range<BK>(mn, mx, pool.slots(), a.window, split, a.nsplit);
  const int lo = rg.lo, hi = rg.hi, start = rg.start, n = rg.n;
  const auto src = pool.stream(b, h);

  // Q fragments of this warp's 16 rows (rows past the end are 0) and their
  // positions (-1: sees nothing)
  const int r_lo = row0 + wr * 16 + g, r_hi = r_lo + 8;
  const bool ok_lo = r_lo < rows, ok_hi = r_hi < rows;
  // wgmma runs on whole warpgroups of 64 rows, mma.sync on warps of 16
  const bool active = row0 + (C::WGMMA ? (warp / 4) * 64 : wr * 16) < rows;
  uint32_t qa[KS][4];
  {
    const bf16* q_lo = q + (static_cast<size_t>(bh) * rows + (ok_lo ? r_lo : 0)) * D + 2 * t;
    const bf16* q_hi = q + (static_cast<size_t>(bh) * rows + (ok_hi ? r_hi : 0)) * D + 2 * t;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      qa[kk][0] = ok_lo ? ld32(q_lo + kk * 16) : 0u;
      qa[kk][1] = ok_hi ? ld32(q_hi + kk * 16) : 0u;
      qa[kk][2] = ok_lo ? ld32(q_lo + kk * 16 + 8) : 0u;
      qa[kk][3] = ok_hi ? ld32(q_hi + kk * 16 + 8) : 0u;
    }
  }
  const int qp[2] = {ok_lo ? q_pos[b * a.S + r_lo % a.S] : -1,
                     ok_hi ? q_pos[b * a.S + r_hi % a.S] : -1};
  // the warp's least and largest position: a slice of a tile that every
  // row of the warp sees whole skips the mask (as does a warp of a wgmma
  // warpgroup with no rows of its own, whose results are dropped)
  const bool own_rows = row0 + wr * 16 < rows;
  const int qmin = warp_imin(min(ok_lo ? qp[0] : INT_MAX, ok_hi ? qp[1] : INT_MAX));
  const int qmax = warp_imax(max(ok_lo ? qp[0] : INT_MIN, ok_hi ? qp[1] : INT_MIN));

  // Loads. Thread x moves the 16-byte chunks at column col of rows r0 + k *
  // RSTEP (k < CHUNKS) of each tile, so their shared-memory offsets are
  // fixed (RSTEP is a multiple of 8: every chunk has chunk 0's swizzle)
  // and a tile in consecutive pool rows costs one base address.
  constexpr int VEC = 16 / static_cast<int>(sizeof(KT));
  constexpr int CPR = D / VEC;  // chunks per row
  constexpr int RSTEP = THREADS / CPR, CHUNKS = BK / RSTEP;
  static_assert(THREADS % CPR == 0 && BK % RSTEP == 0 && (QUANT || RSTEP % 8 == 0), "chunks");
  constexpr int ASTEP = QUANT ? RSTEP * C::LD8 : RSTEP * 128;
  const int r0 = threadIdx.x / CPR, col = (threadIdx.x % CPR) * VEC;
  const int at0 = QUANT ? r0 * C::LD8 + col : swizzled(BK, r0, col);
  // tile `it` of this split into ring stage it % STAGES
  auto load = [&](int it) {
    const int slot0 = (start + it) * BK;
    unsigned char* st = smem + (it % STAGES) * C::STAGE + at0;
    const bool inside = slot0 >= lo && slot0 + BK - 1 <= hi;
    if (src.contiguous()) {
      const size_t base = src.at(slot0) + r0;
      const KT* gk = kp + base * D + col;
      const KT* gv = vp + base * D + col;
#pragma unroll
      for (int k = 0; k < CHUNKS; ++k) {
        const int slot = slot0 + r0 + k * RSTEP;
        const bool ok = inside || (slot >= lo && slot <= hi);
        cp_async16(st + k * ASTEP, ok ? gk + k * RSTEP * D : kp, ok);
        cp_async16(st + C::TILE + k * ASTEP, ok ? gv + k * RSTEP * D : vp, ok);
      }
    } else {
#pragma unroll
      for (int k = 0; k < CHUNKS; ++k) {
        const int slot = slot0 + r0 + k * RSTEP;
        const bool ok = slot >= lo && slot <= hi;
        const size_t row = ok ? src.at(slot) : 0;
        cp_async16(st + k * ASTEP, kp + row * D + col, ok);
        cp_async16(st + C::TILE + k * ASTEP, vp + row * D + col, ok);
      }
    }
    if (QUANT && threadIdx.x < BK) {
      float* ssc = reinterpret_cast<float*>(smem + (it % STAGES) * C::STAGE + 2 * C::TILE);
      const int slot = slot0 + threadIdx.x;
      const bool ok = slot >= lo && slot <= hi;
      const size_t row = ok ? src.at(slot) : 0;
      cp_async4(ssc + threadIdx.x, ks + row, ok);
      cp_async4(ssc + BK + threadIdx.x, vs + row, ok);
    }
  };

  const float sl2 = LOG2E / sqrtf(static_cast<float>(D));
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DT * 4];
#pragma unroll
  for (int i = 0; i < DT * 4; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) load(s);
    cp_async_commit();
  }
  for (int it = 0; it < n; ++it) {
    cp_async_wait<STAGES - 2>();
    fence_async_shared();
    __syncthreads();  // tile it is in; every warp is done with tile it - 1
    if (it + STAGES - 1 < n) load(it + STAGES - 1);
    cp_async_commit();
    unsigned char* st = smem + (it % STAGES) * C::STAGE;
    const unsigned char* tk = st;
    const unsigned char* tv = st + C::TILE;
    const float* tks = nullptr;
    const float* tvs = nullptr;
    if constexpr (QUANT) {
      unsigned char* ck = smem + C::CONV_OFF;
      convert_tile<D, THREADS>(ck, reinterpret_cast<const int8_t*>(st), C::LD8);
      convert_tile<D, THREADS>(ck + C::TILE_B, reinterpret_cast<const int8_t*>(st + C::TILE),
                               C::LD8);
      fence_async_shared();
      __syncthreads();
      tk = ck;
      tv = ck + C::TILE_B;
      tks = reinterpret_cast<const float*>(st + 2 * C::TILE);
      tvs = tks + BK;
    }
    if (!active) continue;

    const int c0 = ws * NS;                   // the warp's first column of the tile
    const int s_lo = (start + it) * BK + c0;  // ... and its slot
    float sc[NT * 4];
#pragma unroll
    for (int i = 0; i < NT * 4; ++i) sc[i] = 0.f;
    if constexpr (C::WGMMA) {
      const uint64_t kd = desc(reinterpret_cast<const bf16*>(tk), 16, 1024);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) WgmmaRK<64>::run(sc, qa[kk], kd, kstep(kk, BK), 1);
      wg_commit();
      wg_wait<0>();
      pin(sc);
    } else {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t fb[4];
          ldmatrix_x4(fb, reinterpret_cast<const bf16*>(
                              tk + swizzled(BK, c0 + j * 8 + (lane >> 4) * 8 + (lane & 7),
                                            kk * 16 + ((lane >> 3) & 1) * 8)));
          mma16816(*reinterpret_cast<float(*)[4]>(sc + 4 * j), qa[kk], fb[0], fb[1]);
          mma16816(*reinterpret_cast<float(*)[4]>(sc + 4 * j + 4), qa[kk], fb[2], fb[3]);
        }
      }
    }

    // the online softmax in log2 units: bf16 logits are scaled inside the
    // exponent's fma, int8 ones first by the column's K scale; the mask
    // where the slice is not seen whole
    const float scl = QUANT ? 1.f : sl2;
    if constexpr (QUANT) {
#pragma unroll
      for (int i = 0; i < NT * 4; ++i) sc[i] *= tks[c0 + (i >> 2) * 8 + 2 * t + (i & 1)] * sl2;
    }
    const bool whole = !own_rows || (s_lo + NS - 1 <= min(qmin, hi) &&
                                     (a.window <= 0 || s_lo > qmax - a.window));
    if (!whole) {
#pragma unroll
      for (int i = 0; i < NT * 4; ++i) {
        const int slot = s_lo + (i >> 2) * 8 + 2 * t + (i & 1), p = qp[(i >> 1) & 1];
        if (slot > p || slot > hi || (a.window > 0 && slot <= p - a.window)) sc[i] = -INFINITY;
      }
    }
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < NT * 4; ++i) mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], sc[i]);
    float ms[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn2 = fmaxf(m[r], quad_max(mt[r]) * scl);
      ms[r] = mn2 == -INFINITY ? 0.f : mn2;
      alpha[r] = exp2f(m[r] - ms[r]);
      m[r] = mn2;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < NT * 4; ++i) {
      const float p = exp2f(fmaf(sc[i], scl, -ms[(i >> 1) & 1]));
      l[(i >> 1) & 1] += p;  // this thread's columns; the quad's sum is taken at the end
      sc[i] = QUANT ? p * tvs[c0 + (i >> 2) * 8 + 2 * t + (i & 1)] : p;
    }
    if (alpha[0] != 1.f || alpha[1] != 1.f) {  // a row's max moved
#pragma unroll
      for (int i = 0; i < DT * 4; ++i) acc[i] *= alpha[(i >> 1) & 1];
    }
    uint32_t pa[NS / 16][4];
#pragma unroll
    for (int kk = 0; kk < NS / 16; ++kk)  // P rounded to bf16
      c_to_a(pa[kk], *reinterpret_cast<const float(*)[4]>(sc + 8 * kk),
             *reinterpret_cast<const float(*)[4]>(sc + 8 * kk + 4));
    if constexpr (C::WGMMA) {
      const uint64_t vd = desc(reinterpret_cast<const bf16*>(tv), BK * PANEL * 2, 1024);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) Wgmma<D>::rs(acc, pa[kk], vd, mnstep(kk));
      wg_commit();
      wg_wait<0>();
      pin(acc);
    } else {
#pragma unroll
      for (int kk = 0; kk < NS / 16; ++kk) {
#pragma unroll
        for (int nn = 0; nn < DT; nn += 2) {
          uint32_t fb[4];
          ldmatrix_x4_trans(fb, reinterpret_cast<const bf16*>(
                                    tv + swizzled(BK, c0 + kk * 16 + ((lane >> 3) & 1) * 8 +
                                                          (lane & 7),
                                                  nn * 8 + (lane >> 4) * 8)));
          mma16816(*reinterpret_cast<float(*)[4]>(acc + 4 * nn), pa[kk], fb[0], fb[1]);
          mma16816(*reinterpret_cast<float(*)[4]>(acc + 4 * nn + 4), pa[kk], fb[2], fb[3]);
        }
      }
    }
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);

  // Epilogue, through the ring's shared memory: every warp's (m, l, acc);
  // per row the weights of its WS slices; then the CTA's rows, coalesced,
  // to the output (one split) or to the partials.
  cp_async_wait<0>();
  __syncthreads();
  constexpr int LDO = C::LDO;
  float* s_acc = reinterpret_cast<float*>(smem);  // [WARPS][16][LDO]
  float* s_m = s_acc + WARPS * 16 * LDO;          // [WARPS][16]
  float* s_l = s_m + WARPS * 16;                  // [WARPS][16]
  float* s_row = s_l + WARPS * 16;                // [RB][WS + 2]: weights, m, l
  {
    float* mine = s_acc + warp * 16 * LDO + 2 * t;
#pragma unroll
    for (int nn = 0; nn < DT; ++nn) {
      *reinterpret_cast<float2*>(mine + g * LDO + nn * 8) =
          make_float2(acc[4 * nn], acc[4 * nn + 1]);
      *reinterpret_cast<float2*>(mine + (g + 8) * LDO + nn * 8) =
          make_float2(acc[4 * nn + 2], acc[4 * nn + 3]);
    }
    if (t == 0) {
      s_m[warp * 16 + g] = m[0];
      s_m[warp * 16 + g + 8] = m[1];
      s_l[warp * 16 + g] = l[0];
      s_l[warp * 16 + g + 8] = l[1];
    }
  }
  __syncthreads();
  if (threadIdx.x < RB) {
    const int r = threadIdx.x, w0 = (r / 16) * WS, rr = r % 16;
    float mr = -INFINITY;
#pragma unroll
    for (int i = 0; i < WS; ++i)
      if (s_l[(w0 + i) * 16 + rr] > 0.f) mr = fmaxf(mr, s_m[(w0 + i) * 16 + rr]);
    float lr = 0.f;
#pragma unroll
    for (int i = 0; i < WS; ++i) {
      const float li = s_l[(w0 + i) * 16 + rr];
      const float w = li > 0.f ? exp2f(s_m[(w0 + i) * 16 + rr] - mr) : 0.f;
      s_row[r * (WS + 2) + i] = w;
      lr = fmaf(li, w, lr);
    }
    s_row[r * (WS + 2) + WS] = mr;
    s_row[r * (WS + 2) + WS + 1] = lr;
  }
  __syncthreads();
  const bool direct = a.nsplit == 1;
  const size_t orow = static_cast<size_t>(bh) * rows + row0;
  const size_t prow = (static_cast<size_t>(split) * gridDim.z + bh) * rows + row0;
  for (int idx = threadIdx.x; idx < valid_rows * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    const float* wrow = s_row + r * (WS + 2);
    const float* arow = s_acc + ((r / 16) * WS * 16 + r % 16) * LDO + c;
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < WS; ++i) v = fmaf(wrow[i], arow[i * 16 * LDO], v);
    const float lr = wrow[WS + 1];
    if (direct) {
      out[(orow + r) * D + c] = __float2bfloat16(lr > 0.f ? v / lr : 0.f);
    } else {
      part_acc[(prow + r) * D + c] = v;
      if (c == 0) {
        part_ml[(prow + r) * 2] = lr > 0.f ? wrow[WS] * LN2 : NEG;
        part_ml[(prow + r) * 2 + 1] = lr;
      }
    }
  }
}

template <class Pool, typename KT, int D, int WS>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* q_pos, void* out, void* part_acc, void* part_ml, int B, const Pool& pool,
           const Args& a, cudaStream_t stream) {
  using C = Cfg<KT, D, WS>;
  if (a.nsplit < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = decode_tc_kernel<Pool, KT, D, WS>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.rows + C::RB - 1) / C::RB, a.nsplit, B * a.Hkv);
  kern<<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(q_pos), static_cast<bf16*>(out), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), pool, a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.nsplit == 1) return static_cast<int>(e);
  return launch_merge<bf16, D>(part_acc, part_ml, out, B * a.Hkv, a.rows, a.nsplit, stream);
}

// The tensor-core kernel for (kv_int8, d, slices); any other d or slice
// count is refused.
template <class Pool>
int launch_any(int kv_int8, int d, int slices, const void* q, const void* k, const void* v,
               const void* ks, const void* vs, const void* q_pos, void* out, void* part_acc,
               void* part_ml, int B, const Pool& pool, const Args& a, cudaStream_t stream) {
#define TC_LAUNCH(KT, DD, WS)                                                                 \
  return launch<Pool, KT, DD, WS>(q, k, v, ks, vs, q_pos, out, part_acc, part_ml, B, pool, a, \
                                  stream)
#define TC_SLICES(KT, DD)                 \
  switch (slices) {                       \
    case 1: TC_LAUNCH(KT, DD, 1);         \
    case 4: TC_LAUNCH(KT, DD, 4);         \
    default: break;                       \
  }
  if (kv_int8) {
    if (d == 64) TC_SLICES(int8_t, 64)
    if (d == 128) TC_SLICES(int8_t, 128)
  } else {
    if (d == 64) TC_SLICES(bf16, 64)
    if (d == 128) TC_SLICES(bf16, 128)
  }
#undef TC_SLICES
#undef TC_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc

// One call of K1 or K3 over `pool`. design 1 (tensor cores) takes bf16 q
// (q_dtype 1) with d in {64, 128} and `slices` (1 or 4) slices of each
// tile per row block; design 0 (FMA) takes fp32 q (q_dtype 0), or bf16 q
// with d = 256. Any other pairing is refused. kv_int8: int8 K/V codes with
// fp32 per-slot scales; else K/V have q's dtype. part_acc: fp32 (nsplit,
// B * Hkv, rows, d); part_ml: fp32 (nsplit, B * Hkv, rows, 2) (unused with
// nsplit = 1 on the tensor cores). Returns cudaGetLastError() after the
// launches.
template <class Pool>
int run(int design, int q_dtype, int kv_int8, int d, int slices, const void* q, const void* k,
        const void* v, const void* ks, const void* vs, const void* q_pos, void* out,
        void* part_acc, void* part_ml, int B, const Pool& pool, const Args& a,
        cudaStream_t stream) {
  if (design == 1) {
    if (q_dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    return tc::launch_any(kv_int8, d, slices, q, k, v, ks, vs, q_pos, out, part_acc, part_ml, B,
                          pool, a, stream);
  }
  if (design != 0 || q_dtype < 0 || q_dtype > 1 || (q_dtype == 1 && d != 256))
    return static_cast<int>(cudaErrorInvalidValue);
#define FMA_LAUNCH(QT, KT, DD)                                                                   \
  return launch_fma<Pool, QT, KT, DD>(q, k, v, ks, vs, q_pos, out, part_acc, part_ml, B, pool, a, \
                                      stream)
#define FMA_FP32(KT)                     \
  if (d == 64) FMA_LAUNCH(float, KT, 64);   \
  if (d == 128) FMA_LAUNCH(float, KT, 128); \
  if (d == 256) FMA_LAUNCH(float, KT, 256);
  if (q_dtype == 1) {
    if (kv_int8) FMA_LAUNCH(bf16, int8_t, 256);
    FMA_LAUNCH(bf16, bf16, 256);
  }
  if (kv_int8) {
    FMA_FP32(int8_t)
  } else {
    FMA_FP32(float)
  }
#undef FMA_FP32
#undef FMA_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
