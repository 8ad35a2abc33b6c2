// K3: paged decode attention over a shared KV page pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel videollm_online_tpu/ops/paged_attention.py
// (paged_decode_attention / _kernel).
//
// What it computes. q (B, Hq, S, d) of B streams attends each stream's K/V,
// which lives in pages of one pool: logical slot j of stream b is row
// j % page of pool page table[b, j / page], i.e. element
// pool[layer][table[b][j / page]][h][j % page][:] of the (L, P, Hkv, page, d)
// pools. The G = Hq / Hkv query heads of a kv head share its K/V, so they are
// folded into rows = G * S query rows (row r is head h * G + r / S, query
// r % S). Slot j is visible to a row iff j <= q_pos and, with a window,
// j > q_pos - window. Softmax is online in fp32. With int8 K/V the per-slot
// fp32 scales (paged like the codes) multiply the logits (K) and the
// probabilities (V); no dequantized tile is ever formed. Probabilities are
// rounded to q's dtype before P.V, as the TPU kernel rounds them. A row with
// nothing visible outputs 0.
//
// Bound. The serving loop calls this for every paged forward: a 1-token
// decode, a 20-token spec verify, a 91-token chunk ingest and a 128-token
// prompt. Each must read every visible slot's K and V once: 2 * Hkv * d *
// sizeof(kv) bytes a slot (plus 8 bytes of scales for int8), and does
// 4 * Hq * S * d flops a slot. At S <= 20 that is far below the card's
// ~295 flops per byte, so decode and verify are bound by bytes; at S = 91 and
// 128 with bf16 K/V the bound moves to operations on the tensor cores, which
// this version, plain fp32 FMA like K1, does not use (mma/wgmma tiles are
// later work).
//
// Design, after K1 (csrc/decode_attention.cu). The TPU grid is (B, Hkv, MAXP)
// with the page axis run in order. Here each stream's visible slot range
// [first, last] is cut into 32-slot tiles and split evenly across `nsplit`
// CTAs (flash-decoding); a CTA holds 16 query rows of one (stream, kv head),
// streams its tiles with 16-byte loads, holding the next tile in registers
// while it computes on the current one in shared memory, and writes a
// partial (m, l, acc) to fp32 scratch that a second kernel merges. Every CTA
// finds its range from q_pos on the device (no host readback per layer).
// Each row of a tile looks up its own page in the table, so any page size
// works and a tile may straddle pages. Rows of a tile past the stream's last
// visible slot are not read and load as zeros: junk written past a stream's
// offset (bucket padding, the shared trash page 0) never enters a product,
// and pages wholly past the last visible slot or below the window are never
// touched. Pool offsets are 64-bit: a pool of 16 streams x 16 pages of 512
// slots at 8B widths holds more elements than an int reaches.

#include <climits>

#include "attention_common.cuh"

namespace {

// Where one stream's K/V rows live: the pool row of logical slot j is
// (head_base + table[j / page] * Hkv) * page + j % page, counted in rows of
// d elements (and, for the scale pools, in elements).
struct PagedRows {
  const int* table;   // this stream's MAXP page entries
  size_t head_base;   // layer * P * Hkv + h
  int Hkv, page;

  __device__ __forceinline__ size_t row(int slot) const {
    const int lp = slot / page;
    const size_t phys = static_cast<size_t>(__ldg(table + lp));
    return (head_base + phys * Hkv) * page + (slot - lp * page);
  }
};

struct Args {
  int B, Hkv, S, rows, P, page, maxp, layer, window, nsplit;
};

// grid (nsplit, B * Hkv, ceil(rows / R)); one CTA = one split of a stream's
// visible tiles x one kv head x R query rows.
template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(THREADS)
k3_split_kernel(const QT* __restrict__ q, const KT* __restrict__ pool_k,
                const KT* __restrict__ pool_v, const float* __restrict__ k_scale,
                const float* __restrict__ v_scale, const int* __restrict__ table,
                const int* __restrict__ q_pos, float* __restrict__ part_acc,
                float* __restrict__ part_ml, Args a) {
  constexpr bool QUANT = std::is_same<KT, int8_t>::value;
  constexpr int CPL = D / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* sK = smem;                  // BK x (D + 1): padded, lane j reads row j
  float* sV = sK + BK * (D + 1);     // BK x D
  float* sQ = sV + BK * D;           // R x D
  float* sP = sQ + R * D;            // R x BK
  float* sKs = sP + R * BK;          // BK
  float* sVs = sKs + BK;             // BK
  __shared__ int s_range[3];

  const int split = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / a.Hkv;
  const int h = bh % a.Hkv;
  const int row0 = blockIdx.z * R;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rows = a.rows;
  const int valid_rows = min(R, rows - row0);
  const size_t pbase = (static_cast<size_t>(split) * gridDim.y + bh) * rows + row0;

  if (threadIdx.x == 0) {
    // this stream's visible tiles [fb, nb), split evenly over nsplit CTAs;
    // slots past the largest q_pos are never read
    int mx = INT_MIN, mn = INT_MAX;
    for (int s = 0; s < a.S; ++s) {
      const int p = q_pos[b * a.S + s];
      mx = max(mx, p);
      mn = min(mn, p);
    }
    const int slots = a.maxp * a.page;
    mx = min(mx, slots - 1);
    const int nb = mx < 0 ? 0 : mx / BK + 1;
    int fb = 0;
    if (a.window > 0) {
      const int lo = mn - a.window + 1;
      fb = lo > 0 ? lo / BK : 0;
    }
    const int n = max(nb - fb, 0);
    const int per = (n + a.nsplit - 1) / a.nsplit;
    const int start = fb + split * per;
    const int end = min(nb, start + per);
    s_range[0] = start;
    s_range[1] = max(end, start);
    s_range[2] = mx;
  }
  __syncthreads();
  const int start = s_range[0];
  const int end = s_range[1];
  const int last_slot = s_range[2];
  if (start == end) {  // nothing of this stream falls in this split
    for (int i = threadIdx.x; i < valid_rows; i += THREADS) {
      part_ml[(pbase + i) * 2] = NEG;
      part_ml[(pbase + i) * 2 + 1] = 0.f;
    }
    return;
  }

  const PagedRows pr{table + static_cast<size_t>(b) * a.maxp,
                     static_cast<size_t>(a.layer) * a.P * a.Hkv + h, a.Hkv, a.page};
  Tile<KT, D, BK> kt, vt;
  float ks_reg = 0.f, vs_reg = 0.f;
  auto prefetch = [&](int blk) {
    const int slot0 = blk * BK;
    const int nvalid = min(BK, last_slot + 1 - slot0);
    const auto row_of = [&](int r) { return pr.row(slot0 + r); };
    kt.load_rows(pool_k, row_of, nvalid);
    vt.load_rows(pool_v, row_of, nvalid);
    if (QUANT && threadIdx.x < BK) {
      const bool ok = threadIdx.x < nvalid;
      const size_t i = ok ? pr.row(slot0 + threadIdx.x) : 0;
      ks_reg = ok ? k_scale[i] : 0.f;
      vs_reg = ok ? v_scale[i] : 0.f;
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
    qp[i] = row_ok[i] ? q_pos[b * a.S + r % a.S] : 0;
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[i][c] = 0.f;
  }
  for (int blk = start; blk < end; ++blk) {
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
                              blk * BK, last_slot + 1, a.window, qp, row_ok, m, l, acc);
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

template <typename QT, typename KT, int D>
int launch(const void* q, const void* pool_k, const void* pool_v, const void* k_scale,
           const void* v_scale, const void* table, const void* q_pos, void* out,
           void* part_acc, void* part_ml, const Args& a, cudaStream_t stream) {
  constexpr size_t smem = split_smem_bytes<D>();
  auto kern = k3_split_kernel<QT, KT, D>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(a.nsplit, a.B * a.Hkv, (a.rows + R - 1) / R);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(pool_k), static_cast<const KT*>(pool_v),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(table), static_cast<const int*>(q_pos),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_merge<QT, D>(part_acc, part_ml, out, a.B * a.Hkv, a.rows, a.nsplit, stream);
}

template <typename QT, typename KT>
int launch_d(int d, const void* q, const void* pool_k, const void* pool_v, const void* k_scale,
             const void* v_scale, const void* table, const void* q_pos, void* out,
             void* part_acc, void* part_ml, const Args& a, cudaStream_t stream) {
#define K3_LAUNCH(DD)                                                                     \
  return launch<QT, KT, DD>(q, pool_k, pool_v, k_scale, v_scale, table, q_pos, out,       \
                            part_acc, part_ml, a, stream)
  switch (d) {
    case 64: K3_LAUNCH(64);
    case 128: K3_LAUNCH(128);
    case 256: K3_LAUNCH(256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K3_LAUNCH
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16. kv_int8: 0 = pools have q's dtype,
// 1 = int8 codes with fp32 (L, P, Hkv, page) scale pools. table: int32
// (B, maxp); q_pos: int32 (B, S). window <= 0: no window. part_acc: fp32
// (nsplit, B * Hkv, rows, d); part_ml: fp32 (nsplit, B * Hkv, rows, 2).
// Returns cudaGetLastError() after both launches.
extern "C" int k3_paged_decode_attention(
    const void* q, const void* pool_k, const void* pool_v, const void* k_scale,
    const void* v_scale, const void* table, const void* q_pos, void* out, void* part_acc,
    void* part_ml, int B, int Hkv, int S, int rows, int d, int P, int page, int maxp, int layer,
    int window, int nsplit, int q_dtype, int kv_int8, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{B, Hkv, S, rows, P, page, maxp, layer, window, nsplit};
  if (q_dtype == 1) {
    if (kv_int8)
      return launch_d<__nv_bfloat16, int8_t>(d, q, pool_k, pool_v, k_scale, v_scale, table,
                                             q_pos, out, part_acc, part_ml, a, st);
    return launch_d<__nv_bfloat16, __nv_bfloat16>(d, q, pool_k, pool_v, k_scale, v_scale,
                                                  table, q_pos, out, part_acc, part_ml, a, st);
  }
  if (kv_int8)
    return launch_d<float, int8_t>(d, q, pool_k, pool_v, k_scale, v_scale, table, q_pos, out,
                                   part_acc, part_ml, a, st);
  return launch_d<float, float>(d, q, pool_k, pool_v, k_scale, v_scale, table, q_pos, out,
                                part_acc, part_ml, a, st);
}
