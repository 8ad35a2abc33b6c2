// Paged latent attention (MLA) for Hopper (sm_90a): DeepSeek-V2's attention
// in its absorbed form over a shared pool of latent rows
// (ops/mla_attention.py, models/deepseek_v2.py).
//
// What it computes. q (B, S, H, 576) of B streams: per head the nope query
// folded through W_UK (512) and the roped query (64). Every query row
// attends ONE shared "KV head" of its stream: the latent rows of the
// (L, P, page, 576) pool, logical slot j of stream b at row j % page of
// pool page table[b][j / page] (the normed latent c, 512, then the roped
// shared key, 64). Logits are q . row over all 576 values times `scale`;
// the output is the probabilities times the row's first 512 values (c), so
// out is (B, S, H, 512). Row r of a stream is query r / H, head r % H, so
// a stream's S * H rows are contiguous in q and out. Slot j is visible to
// a row at q_pos p iff j <= p and, with a window, j > p - window; only the
// first nvalid[b] queries of stream b are real (the others, padding,
// output 0, as does a row that sees nothing). Softmax is online in fp32;
// probabilities are rounded to bf16 before P.V.
//
// Bound. One visible (row, slot) pair costs 2 * (576 + 512) FLOPs and each
// visible slot's 1152 bytes are read once per row block. An ingest chunk
// (S ~ 88, 1408 rows a stream) and a prompt (S 128) are bound by the
// tensor cores; a decode forward (S 1, 16 rows) by bytes.
//
// Design. A CTA takes 64 rows of one stream and one split of its visible
// slots, with two warpgroups: warpgroup h owns value columns 256 h .. 256
// h + 255. Q (64 x 576) sits in shared memory; the latent streams through
// a 2-stage cp.async ring of 64-slot tiles (each 64 x 576 bf16, 72 KB; 216
// KB in all with Q), stored in the 128-byte swizzle (wgmma.cuh) that wgmma
// reads, K-major for Q K^T and MN-major for P V. Per tile, each warpgroup:
//  * S = Q K^T for all 64 rows and 64 slots: 36 wgmma m64n64k16, both
//    operands from shared memory;
//  * the mask and the online softmax in fp32, P rounded to bf16 in
//    registers;
//  * O += P V over its 256 columns: 2 x 4 wgmma m64n128k16, P from
//    registers, V the tile's columns read in place.
// Both warpgroups compute the same S (the same products in the same
// order, so the same P): the score product is done twice, which costs a
// third more tensor-core work than sharing P would, and needs no exchange
// and one barrier a tile. Splits: a stream's visible tiles are cut evenly
// over nsplit CTAs (flash-decoding); with more than one, each writes an
// fp32 partial (m, l, acc) and mla_merge_kernel merges them in split
// order. Tiles outside a row block's visible range are never read; rows
// of a tile outside it are zero-filled and masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "mma_sync.cuh"
#include "wgmma.cuh"

namespace {

constexpr int DK = 576, DV = 512;
constexpr int BK = 64;                  // slots a tile
constexpr int RB = 64;                  // rows a CTA
constexpr int WARPS = 8, THREADS = WARPS * 32;
constexpr int HALF = DV / 2;            // value columns a warpgroup
constexpr int KSTEPS = DK / 16;
constexpr int TILE = BK * DK * 2;       // bytes of a swizzled latent tile
constexpr int QTILE = RB * DK * 2;
constexpr int SMEM = QTILE + 2 * TILE;
constexpr int CPR = DK / 8;             // 16-byte chunks a row
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG = -1e30f;
static_assert(SMEM <= 227 * 1024, "shared memory");
static_assert(THREADS == 8 * (BK / 2), "a tile's loads: 8 chunks of each of 32 rows a pass");

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

struct Geo {
  int B, S, H, P, page, maxp, layer, window, nsplit;
};

// grid (ceil(S * H / RB), nsplit, B)
__global__ void __launch_bounds__(THREADS, 1)
    mla_paged_kernel(const bf16* __restrict__ q, const bf16* __restrict__ latent,
                     const int* __restrict__ table, const int* __restrict__ q_pos,
                     const int* __restrict__ nvalid, bf16* __restrict__ out,
                     float* __restrict__ part_acc, float* __restrict__ part_ml, Geo a,
                     float scale) {
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* sq = smem;
  unsigned char* ring = smem + QTILE;

  const int b = blockIdx.z, split = blockIdx.y;
  const int rows = a.S * a.H, row0 = blockIdx.x * RB;
  const int valid_rows = min(RB, rows - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  // a warpgroup index that guards a wgmma is broadcast, or ptxas
  // serializes the wgmma
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int nv = min(nvalid[b], a.S);
  const bool direct = a.nsplit == 1;
  const size_t orow = static_cast<size_t>(b) * rows + row0;                    // out row
  const size_t prow = static_cast<size_t>(split) * a.B * rows + orow;        // partial row

  // the real queries of this row block, and the slots they see: [lo, hi]
  const int s_first = row0 / a.H;
  const int s_last = min((row0 + valid_rows - 1) / a.H, nv - 1);
  int mn = INT_MAX, mx = INT_MIN;
  for (int s = s_first; s <= s_last; ++s) {
    const int p = q_pos[b * a.S + s];
    mn = min(mn, p);
    mx = max(mx, p);
  }
  const int slots = a.maxp * a.page;
  int lo = 0, hi = -1, start = 0, n = 0;
  if (s_first <= s_last) {
    lo = a.window > 0 ? max(mn - a.window + 1, 0) : 0;
    hi = min(mx, slots - 1);
    if (hi >= lo) {
      const int fb = lo / BK, nb = hi / BK + 1;
      const int per = (nb - fb + a.nsplit - 1) / a.nsplit;
      start = fb + split * per;
      n = max(min(nb, start + per) - start, 0);
    }
  }
  if (n == 0) {  // nothing of this row block falls in this split
    for (int i = threadIdx.x; i < valid_rows * (direct ? DV / 2 : 1); i += THREADS) {
      if (direct) {
        reinterpret_cast<uint32_t*>(out + orow * DV)[i] = 0u;
      } else {
        part_ml[(prow + i) * 2] = NEG;
        part_ml[(prow + i) * 2 + 1] = 0.f;
      }
    }
    return;
  }

  // where a slot's row lives (in rows of DK elements)
  const int* tab = table + static_cast<size_t>(b) * a.maxp;
  const size_t lbase = static_cast<size_t>(a.layer) * a.P;
  const int shift = (a.page & (a.page - 1)) == 0 ? __ffs(a.page) - 1 : -1;
  auto row_of = [&](int slot) -> size_t {
    const int lp = shift >= 0 ? slot >> shift : slot / a.page;
    return (lbase + static_cast<size_t>(__ldg(tab + lp))) * a.page + (slot - lp * a.page);
  };
  // A tile's loads: thread x moves the 16-byte chunk x % 8 of each
  // 64-column panel of tile rows x / 8 and x / 8 + 32, so its shared-memory
  // offsets are fixed (both rows have the same swizzle) and a tile costs it
  // two page lookups; computing every chunk's row, page and swizzle anew
  // took more time than the tile's products.
  const int lr = threadIdx.x / 8, lc = (threadIdx.x % 8) * 8;
  const int soff = swizzled(BK, lr, lc);
  auto load = [&](int it) {
    const int slot0 = (start + it) * BK;
    unsigned char* st = ring + (it & 1) * TILE + soff;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int slot = slot0 + lr + 32 * h;
      const bool ok = slot >= lo && slot <= hi;
      const bf16* src = ok ? latent + row_of(slot) * DK + lc : latent;
#pragma unroll
      for (int p = 0; p < DK / PANEL; ++p)
        cp_async16(st + h * 32 * 128 + p * BK * 128, ok ? src + p * PANEL : latent, ok);
    }
  };
  // Q of the block's rows (rows past the end zero) and the first tile
  for (int idx = threadIdx.x; idx < RB * CPR; idx += THREADS) {
    const int r = idx / CPR, c = (idx % CPR) * 8;
    const bool ok = r < valid_rows;
    cp_async16(sq + swizzled(RB, r, c), ok ? q + (orow + r) * DK + c : q, ok);
  }
  load(0);
  cp_async_commit();

  // this thread's two rows (the same in both warpgroups) and their
  // positions (-1: padding or past the end)
  const int rl[2] = {(warp % 4) * 16 + g, (warp % 4) * 16 + g + 8};
  int qp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + rl[i];
    qp[i] = (rl[i] < valid_rows && r / a.H < nv) ? q_pos[b * a.S + r / a.H] : -1;
  }
  const float sl2 = scale * LOG2E;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc0[64], acc1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
  const uint64_t qd = desc(reinterpret_cast<const bf16*>(sq), 16, 1024);

  for (int it = 0; it < n; ++it) {
    cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();  // tile it (and Q) in; every warp done with tile it - 1
    if (it + 1 < n) load(it + 1);
    cp_async_commit();
    const bf16* tk = reinterpret_cast<const bf16*>(ring + (it & 1) * TILE);
    const int slot0 = (start + it) * BK;

    // S = Q K^T, 64 rows x 64 slots
    float sc[32];
    const uint64_t kd = desc(tk, 16, 1024);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      Wgmma<64>::ss(sc, qd, kstep(kk, RB), kd, kstep(kk, BK), kk);
    wg_commit();
    wg_wait<0>();
    pin(sc);

    // the mask and the online softmax in log2 units
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int slot = slot0 + (i >> 2) * 8 + 2 * t + (i & 1), p = qp[(i >> 1) & 1];
      if (slot > p || slot > hi || (a.window > 0 && slot <= p - a.window)) sc[i] = -INFINITY;
      mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], sc[i]);
    }
    float ms[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn2 = fmaxf(m[r], quad_max(mt[r]) * sl2);
      ms[r] = mn2 == -INFINITY ? 0.f : mn2;
      alpha[r] = exp2f(m[r] - ms[r]);
      m[r] = mn2;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = exp2f(fmaf(sc[i], sl2, -ms[(i >> 1) & 1]));
      l[(i >> 1) & 1] += sc[i];
    }
    if (alpha[0] != 1.f || alpha[1] != 1.f) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        acc0[i] *= alpha[(i >> 1) & 1];
        acc1[i] *= alpha[(i >> 1) & 1];
      }
    }
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)  // P rounded to bf16
      c_to_a(pa[kk], *reinterpret_cast<const float(*)[4]>(sc + 8 * kk),
             *reinterpret_cast<const float(*)[4]>(sc + 8 * kk + 4));

    // O += P V over this warpgroup's columns, two blocks of 128
    const uint64_t vd0 = desc(tk + (wg * 4) * BK * PANEL, BK * PANEL * 2, 1024);
    const uint64_t vd1 = desc(tk + (wg * 4 + 2) * BK * PANEL, BK * PANEL * 2, 1024);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) Wgmma<128>::rs(acc0, pa[kk], vd0, mnstep(kk));
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) Wgmma<128>::rs(acc1, pa[kk], vd1, mnstep(kk));
    wg_commit();
    wg_wait<0>();
    pin(acc0);
    pin(acc1);
  }

  // the output, or the partial, of this warpgroup's columns
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lt = quad_sum(l[r]);
    if (rl[r] >= valid_rows) continue;
    const int c0 = wg * HALF + 2 * t;
    if (direct) {
      const float inv = lt > 0.f ? 1.f / lt : 0.f;
      uint32_t* o = reinterpret_cast<uint32_t*>(out + (orow + rl[r]) * DV + c0);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        o[j * 4] = pack_bf16(acc0[4 * j + 2 * r] * inv, acc0[4 * j + 2 * r + 1] * inv);
        o[64 + j * 4] = pack_bf16(acc1[4 * j + 2 * r] * inv, acc1[4 * j + 2 * r + 1] * inv);
      }
    } else {
      float2* o = reinterpret_cast<float2*>(part_acc + (prow + rl[r]) * DV + c0);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        o[j * 4] = make_float2(acc0[4 * j + 2 * r], acc0[4 * j + 2 * r + 1]);
        o[64 + j * 4] = make_float2(acc1[4 * j + 2 * r], acc1[4 * j + 2 * r + 1]);
      }
      if (wg == 0 && t == 0) {
        part_ml[(prow + rl[r]) * 2] = lt > 0.f ? m[r] * LN2 : NEG;
        part_ml[(prow + rl[r]) * 2 + 1] = lt;
      }
    }
  }
}

// grid (B * S * H), 128 threads of 4 columns: the nsplit partials of one
// row merged in split order (equal bits run to run); a row whose every
// split is empty outputs 0.
__global__ void __launch_bounds__(128)
    mla_merge_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                     bf16* __restrict__ out, int nsplit, size_t total) {
  const size_t r = blockIdx.x;
  const int c = threadIdx.x * 4;
  float mx = NEG;
  for (int s = 0; s < nsplit; ++s) {
    const float* ml = part_ml + (s * total + r) * 2;
    if (ml[1] > 0.f) mx = fmaxf(mx, ml[0]);
  }
  float lsum = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < nsplit; ++s) {
    const float* ml = part_ml + (s * total + r) * 2;
    if (!(ml[1] > 0.f)) continue;
    const float w = expf(ml[0] - mx);
    lsum = fmaf(ml[1], w, lsum);
    const float4 v = *reinterpret_cast<const float4*>(part_acc + (s * total + r) * DV + c);
    a.x = fmaf(v.x, w, a.x);
    a.y = fmaf(v.y, w, a.y);
    a.z = fmaf(v.z, w, a.z);
    a.w = fmaf(v.w, w, a.w);
  }
  const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
  uint32_t* o = reinterpret_cast<uint32_t*>(out + r * DV + c);
  o[0] = pack_bf16(a.x * inv, a.y * inv);
  o[1] = pack_bf16(a.z * inv, a.w * inv);
}

}  // namespace

// q: bf16 (B, S, H, 576); latent: bf16 (L, P, page, 576); table: int32 (B,
// maxp); q_pos: int32 (B, S); nvalid: int32 (B,); out: bf16 (B, S, H,
// 512). With nsplit > 1, part_acc: fp32 (nsplit, B * S * H, 512) and
// part_ml: fp32 (nsplit, B * S * H, 2). window <= 0: no window. Returns
// cudaGetLastError() after the launches.
extern "C" int mla_paged_attention(const void* q, const void* latent, const void* table,
                                   const void* q_pos, const void* nvalid, void* out,
                                   void* part_acc, void* part_ml, int B, int S, int H, int P,
                                   int page, int maxp, int layer, int window, int nsplit,
                                   float scale, void* stream) {
  if (nsplit < 1 || B < 1 || S < 1 || H < 1 || page < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(mla_paged_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rows = S * H;
  const Geo geo{B, S, H, P, page, maxp, layer, window, nsplit};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  mla_paged_kernel<<<dim3((rows + RB - 1) / RB, nsplit, B), THREADS, SMEM, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(latent),
      static_cast<const int*>(table), static_cast<const int*>(q_pos),
      static_cast<const int*>(nvalid), static_cast<bf16*>(out), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), geo, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return static_cast<int>(e);
  const size_t total = static_cast<size_t>(B) * rows;
  mla_merge_kernel<<<static_cast<unsigned>(total), 128, 0, st>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<bf16*>(out), nsplit, total);
  return static_cast<int>(cudaGetLastError());
}
