// K2: flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the three TPU kernels of videollm_online_tpu/ops/flash_attention.py:
// _flash_fwd (_fwd_kernel) with the forward kernels here, and the two kernels
// of _flash_bwd with the dK/dV kernels (_dkdv_kernel) and the dQ kernels
// (_dq_kernel).
//
// What it computes. q (B, Hq, T, d) attends k/v (B, Hkv, S, d); the G =
// Hq / Hkv query heads of a kv head share its K/V. Slot `col` is visible to
// query `row` iff col < kv_len, row < T and, when causal, col <= row +
// q_offset and, with a window, col > row + q_offset - window. Logits and the
// softmax are fp32; probabilities are rounded to the input dtype before every
// product with V or dO, and dS before every product with Q or K, as the TPU
// kernels round them. The forward writes out (input dtype) and the row
// log-sum-exp lse (fp32, natural log). A row that sees no slot outputs 0
// with lse -1e30 (on the TPU such a row's value depends on its block size).
// The backward recomputes P = exp(S - lse) and uses delta = rowsum(dO * O),
// which the wrapper computes.
//
// Layout on the card. The TPU grid runs its kv axis (forward, dQ) or its q
// axis (dK/dV) in order and carries an accumulator in VMEM from step to step;
// here that axis is a loop inside one CTA, and its bounds are the visible tile
// range, so a dead tile (above the causal diagonal, below the window, past
// kv_len) is never read, as the TPU's index-map clamps skip its DMA.
//   forward: one CTA per (q tile, q head, b); loop over the visible kv tiles.
//   dK/dV:   one CTA per (k tile, kv head, b); loop over the G query heads of
//            the group and the q tiles that see the k tile. dK and dV for the
//            whole group accumulate in fp32 registers and are written once in
//            the input dtype at (B, Hkv, S, d): no per-query-head fp32
//            intermediate (the TPU writes one and sums it in XLA), no atomics.
//   dQ:      one CTA per (q tile, q head, b); loop over the visible kv tiles.
//
// Bound. At the training shapes (B 1, Hq 32, Hkv 8, T = S = 4096, d 128,
// causal, bf16) every kernel is bound by operations: the forward does ~137
// GFLOP against ~84 MB moved (0.139 ms at 989 TFLOP/s), dK/dV ~275 GFLOP,
// dQ ~206; the card needs ~295 operations a byte before the tensor cores
// and not HBM are the limit, and attention does thousands. So each design
// is about keeping the tensor cores fed.
//
// Three designs, picked by the caller for (dtype, d):
//  * bf16, d in {64, 128}, forward and dK/dV (the training path): wgmma
//    on tiles that TMA loads ahead through a ring of mbarrier-guarded slots
//    (hop:: below). Only wgmma reaches Hopper's tensor-core rate; TMA moves
//    a tile with one thread and no registers, and the ring keeps the next
//    tiles' loads in flight behind the current tile's products. The
//    128-byte swizzle serves both operand majors, so no tile is transposed
//    in memory. Logits are prescaled by scale * log2(e) for exp2. Tiles
//    fully inside the visible region skip the mask; the dK/dV kernel skips
//    a block with no visible pair. CTAs run longest first over the whole
//    grid, so the causal tail is short.
//  * bf16, d in {64, 128}, dQ: mma.sync m16n8k16 (bf16 in, fp32 accumulate),
//    4 warps, 64 x 64 tiles staged synchronously, each warp owning 16 rows;
//    dS goes from the accumulators to the next product's A operand in
//    registers.
//  * fp32 (which bf16 tensor cores cannot hold to fp32 accuracy) and bf16
//    with d = 256 (whose accumulators do not fit those registers): the CUDA
//    cores with fp32 FMA: 256 threads as 16 x 16, tiles N x N with N = 64
//    (d <= 128) or 32 (d = 256) staged as fp32 with a row stride of d + 1,
//    each thread holding (N/16) x (N/16) of S and (N/16) rows x (d/16)
//    columns of each accumulator.

#include <cuda.h>  // CUtensorMap and its enums; the library links no libcuda
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TX = 16;        // threads along a tile row
constexpr int THREADS = 256;  // TX x TX
constexpr float NEG = -1e30f;

template <int D>
struct Tile {
  static constexpr int N = D > 128 ? 32 : 64;  // tile rows and columns
  static constexpr int R = N / TX;             // rows (and S columns) per thread
  static constexpr int C = D / TX;             // accumulator columns per thread
  static constexpr int LD = D + 1;             // shared-memory row stride
  static constexpr int LP = N + 1;             // stride of an N x N tile
};

struct Shape {
  int B, Hq, Hkv, T, S, kv_len, q_offset, causal, window;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Rounds a probability or dS to the input dtype, as the TPU kernel's
// .astype() before each product does.
template <typename T>
__device__ __forceinline__ float round_like(float x) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) return __bfloat162float(__float2bfloat16(x));
  return x;
}

// Reductions over the 16 lanes of a half-warp (one tile row's threads).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = TX / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = TX / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool visible(const Shape& s, int row, int col) {
  if (row >= s.T || col >= s.kv_len) return false;
  const int qpos = row + s.q_offset;
  if (s.causal && col > qpos) return false;
  if (s.window > 0 && col <= qpos - s.window) return false;
  return true;
}

// The kv tiles [first, last] of BN rows that some row of the q tile
// [q0, q0 + BM) can see (the forward's and dQ's loop).
__device__ __forceinline__ void kv_tile_range(const Shape& s, int q0, int BM, int BN, int& first,
                                              int& last) {
  last = (s.kv_len + BN - 1) / BN - 1;
  if (s.causal) last = min(last, (min(q0 + BM, s.T) - 1 + s.q_offset) / BN);
  first = 0;
  if (s.window > 0) {
    const int lo = q0 + s.q_offset - s.window + 1;
    first = lo > 0 ? lo / BN : 0;
  }
}

// The q tiles [first, last] of BM rows with some row that sees a column of
// the k tile [k0, k0 + BN) (the dK/dV loop); last < first if none.
__device__ __forceinline__ void q_tile_range(const Shape& s, int k0, int BM, int BN, int& first,
                                             int& last) {
  first = 0;
  last = (s.T + BM - 1) / BM - 1;
  if (k0 >= s.kv_len) {
    last = -1;
    return;
  }
  if (s.causal) {
    const int lo = k0 - s.q_offset;
    first = lo > 0 ? lo / BM : 0;
  }
  if (s.window > 0) {
    const int hi = min(k0 + BN, s.kv_len) - 1 - s.q_offset + s.window - 1;
    if (hi < 0) {
      last = -1;
      return;
    }
    last = min(last, hi / BM);
  }
}

// Rows [row0, row0 + N) of a (rows, D) slab into shared memory as fp32 with
// row stride D + 1; rows past the slab are zero.
template <typename T, int D, int N>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int row0, int rows) {
  for (int idx = threadIdx.x; idx < N * D; idx += THREADS) {
    const int r = idx / D, c = idx - r * D;
    const int g = row0 + r;
    dst[r * (D + 1) + c] = g < rows ? to_f(src[static_cast<size_t>(g) * D + c]) : 0.f;
  }
}

template <int N>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int row0,
                                          int rows) {
  for (int i = threadIdx.x; i < N; i += THREADS) dst[i] = row0 + i < rows ? src[row0 + i] : 0.f;
}

// acc[a][c] = sum_k A[ty + 16a][k] * Bm[tx + 16c][k]: one thread's block of
// an N x N product of two staged tiles over their D columns.
template <int D>
__device__ __forceinline__ void dot_rows(const float* A, const float* Bm, int ty, int tx,
                                         float (&acc)[Tile<D>::R][Tile<D>::R]) {
  constexpr int R = Tile<D>::R, LD = Tile<D>::LD;
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < R; ++c) acc[a][c] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < D; ++kk) {
    float av[R], bv[R];
#pragma unroll
    for (int a = 0; a < R; ++a) av[a] = A[(ty + TX * a) * LD + kk];
#pragma unroll
    for (int c = 0; c < R; ++c) bv[c] = Bm[(tx + TX * c) * LD + kk];
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int c = 0; c < R; ++c) acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    k2_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ out, float* __restrict__ lse, Shape s) {
  constexpr int N = Tile<D>::N, R = Tile<D>::R, C = Tile<D>::C, LD = Tile<D>::LD,
                LP = Tile<D>::LP;
  extern __shared__ __align__(16) unsigned char k2_smem[];
  float* Qs = reinterpret_cast<float*>(k2_smem);
  float* Ks = Qs + N * LD;
  float* Vs = Ks + N * LD;
  float* Ps = Vs + N * LD;  // N x LP

  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
  const int q0 = ((s.T + N - 1) / N - 1 - static_cast<int>(blockIdx.x)) * N;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t qrow = (static_cast<size_t>(b) * s.Hq + h) * s.T;
  const size_t krow = (static_cast<size_t>(b) * s.Hkv + h / (s.Hq / s.Hkv)) * s.S;

  load_tile<T, D, N>(Qs, q + qrow * D, q0, s.T);

  float m[R], l[R], acc[R][C];
#pragma unroll
  for (int a = 0; a < R; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[a][c] = 0.f;
  }

  int first, last;
  kv_tile_range(s, q0, N, N, first, last);
  for (int kt = first; kt <= last; ++kt) {
    const int k0 = kt * N;
    __syncthreads();  // the last tile's K/V/P reads are done
    load_tile<T, D, N>(Ks, k + krow * D, k0, s.S);
    load_tile<T, D, N>(Vs, v + krow * D, k0, s.S);
    __syncthreads();

    float sc[R][R];
    dot_rows<D>(Qs, Ks, ty, tx, sc);
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const int row = q0 + ty + TX * a;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const float x = visible(s, row, k0 + tx + TX * c) ? sc[a][c] * s.scale : -INFINITY;
        sc[a][c] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[a], row_max(mx));
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[a] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const float p = sc[a][c] == -INFINITY ? 0.f : expf(sc[a][c] - m_new);
        psum += p;
        Ps[(ty + TX * a) * LP + tx + TX * c] = round_like<T>(p);
      }
      l[a] = l[a] * alpha + row_sum(psum);
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[a][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < N; ++j) {
      float p[R], vv[C];
#pragma unroll
      for (int a = 0; a < R; ++a) p[a] = Ps[(ty + TX * a) * LP + j];
#pragma unroll
      for (int c = 0; c < C; ++c) vv[c] = Vs[j * LD + tx + TX * c];
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[a][c] = fmaf(p[a], vv[c], acc[a][c]);
    }
  }

#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int row = q0 + ty + TX * a;
    if (row >= s.T) continue;
    T* o = out + (qrow + row) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) store(o + tx + TX * c, l[a] == 0.f ? 0.f : acc[a][c] / l[a]);
    if (tx == 0) lse[qrow + row] = l[a] == 0.f ? NEG : m[a] + logf(l[a]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    k2_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                   Shape s) {
  constexpr int N = Tile<D>::N, R = Tile<D>::R, C = Tile<D>::C, LD = Tile<D>::LD,
                LP = Tile<D>::LP;
  extern __shared__ __align__(16) unsigned char k2_smem[];
  float* Ks = reinterpret_cast<float*>(k2_smem);
  float* Vs = Ks + N * LD;
  float* Qs = Vs + N * LD;
  float* dOs = Qs + N * LD;
  float* Ps = dOs + N * LD;  // N x LP, q rows by k columns
  float* dSs = Ps + N * LP;  // N x LP
  float* Ls = dSs + N * LP;  // N
  float* Dl = Ls + N;        // N

  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
  const int k0 = blockIdx.x * N;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = s.Hq / s.Hkv;
  const size_t krow = (static_cast<size_t>(b) * s.Hkv + hk) * s.S;

  load_tile<T, D, N>(Ks, k + krow * D, k0, s.S);
  load_tile<T, D, N>(Vs, v + krow * D, k0, s.S);

  float dka[R][C], dva[R][C];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < C; ++c) dka[a][c] = dva[a][c] = 0.f;

  int first, last;
  q_tile_range(s, k0, N, N, first, last);
  for (int g = 0; g < G; ++g) {
    const size_t qrow = (static_cast<size_t>(b) * s.Hq + hk * G + g) * s.T;
    for (int qt = first; qt <= last; ++qt) {
      const int q0 = qt * N;
      __syncthreads();  // the last tile's Q/dO/P/dS reads are done
      load_tile<T, D, N>(Qs, q + qrow * D, q0, s.T);
      load_tile<T, D, N>(dOs, dout + qrow * D, q0, s.T);
      load_rows<N>(Ls, lse + qrow, q0, s.T);
      load_rows<N>(Dl, delta + qrow, q0, s.T);
      __syncthreads();

      float sc[R][R], dp[R][R];
      dot_rows<D>(Qs, Ks, ty, tx, sc);
      dot_rows<D>(dOs, Vs, ty, tx, dp);
#pragma unroll
      for (int a = 0; a < R; ++a) {
        const int i = ty + TX * a;
#pragma unroll
        for (int c = 0; c < R; ++c) {
          const int j = tx + TX * c;
          const float p = visible(s, q0 + i, k0 + j) ? expf(sc[a][c] * s.scale - Ls[i]) : 0.f;
          const float ds = p * (dp[a][c] - Dl[i]) * s.scale;
          Ps[i * LP + j] = round_like<T>(p);
          dSs[i * LP + j] = round_like<T>(ds);
        }
      }
      __syncthreads();

      // dV[j] += sum_i P[i][j] dO[i],  dK[j] += sum_i dS[i][j] Q[i],  j = ty + 16a
#pragma unroll 2
      for (int i = 0; i < N; ++i) {
        float p[R], d_s[R], o[C], qq[C];
#pragma unroll
        for (int a = 0; a < R; ++a) {
          p[a] = Ps[i * LP + ty + TX * a];
          d_s[a] = dSs[i * LP + ty + TX * a];
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          o[c] = dOs[i * LD + tx + TX * c];
          qq[c] = Qs[i * LD + tx + TX * c];
        }
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
          for (int c = 0; c < C; ++c) {
            dva[a][c] = fmaf(p[a], o[c], dva[a][c]);
            dka[a][c] = fmaf(d_s[a], qq[c], dka[a][c]);
          }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int j = k0 + ty + TX * a;
    if (j >= s.S) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      store(dk + (krow + j) * D + tx + TX * c, dka[a][c]);
      store(dv + (krow + j) * D + tx + TX * c, dva[a][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    k2_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq, Shape s) {
  constexpr int N = Tile<D>::N, R = Tile<D>::R, C = Tile<D>::C, LD = Tile<D>::LD,
                LP = Tile<D>::LP;
  extern __shared__ __align__(16) unsigned char k2_smem[];
  float* Qs = reinterpret_cast<float*>(k2_smem);
  float* dOs = Qs + N * LD;
  float* Ks = dOs + N * LD;
  float* Vs = Ks + N * LD;
  float* dSs = Vs + N * LD;  // N x LP
  float* Ls = dSs + N * LP;  // N
  float* Dl = Ls + N;        // N

  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
  const int q0 = ((s.T + N - 1) / N - 1 - static_cast<int>(blockIdx.x)) * N;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t qrow = (static_cast<size_t>(b) * s.Hq + h) * s.T;
  const size_t krow = (static_cast<size_t>(b) * s.Hkv + h / (s.Hq / s.Hkv)) * s.S;

  load_tile<T, D, N>(Qs, q + qrow * D, q0, s.T);
  load_tile<T, D, N>(dOs, dout + qrow * D, q0, s.T);
  load_rows<N>(Ls, lse + qrow, q0, s.T);
  load_rows<N>(Dl, delta + qrow, q0, s.T);

  float dqa[R][C];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < C; ++c) dqa[a][c] = 0.f;

  int first, last;
  kv_tile_range(s, q0, N, N, first, last);
  for (int kt = first; kt <= last; ++kt) {
    const int k0 = kt * N;
    __syncthreads();  // the last tile's K/dS reads are done
    load_tile<T, D, N>(Ks, k + krow * D, k0, s.S);
    load_tile<T, D, N>(Vs, v + krow * D, k0, s.S);
    __syncthreads();

    float sc[R][R], dp[R][R];
    dot_rows<D>(Qs, Ks, ty, tx, sc);
    dot_rows<D>(dOs, Vs, ty, tx, dp);
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const int i = ty + TX * a;
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const int j = tx + TX * c;
        const float p = visible(s, q0 + i, k0 + j) ? expf(sc[a][c] * s.scale - Ls[i]) : 0.f;
        dSs[i * LP + j] = round_like<T>(p * (dp[a][c] - Dl[i]) * s.scale);
      }
    }
    __syncthreads();

    // dQ[i] += sum_j dS[i][j] K[j],  i = ty + 16a
#pragma unroll 4
    for (int j = 0; j < N; ++j) {
      float d_s[R], kk[C];
#pragma unroll
      for (int a = 0; a < R; ++a) d_s[a] = dSs[(ty + TX * a) * LP + j];
#pragma unroll
      for (int c = 0; c < C; ++c) kk[c] = Ks[j * LD + tx + TX * c];
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int c = 0; c < C; ++c) dqa[a][c] = fmaf(d_s[a], kk[c], dqa[a][c]);
    }
  }

#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int row = q0 + ty + TX * a;
    if (row >= s.T) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) store(dq + (qrow + row) * D + tx + TX * c, dqa[a][c]);
  }
}

// ---------------------------------------------------------------------------
// bf16, d <= 128: the same three kernels on the tensor cores (mma.sync
// m16n8k16, bf16 in, fp32 accumulate). 4 warps; a tile is 64 x 64; each
// warp owns 16 rows of its tile (q rows for the forward and dQ, k rows for
// dK/dV). Tiles are staged in shared memory as bf16 with a row stride of
// d + 8 (64 + 8 for the transposed copies), so the 8 rows x 4 lanes of a
// fragment load fall on 32 different banks. S and dP stay in the mma
// accumulators; P and dS are rounded to bf16 and repacked in registers as
// the A operand of the next product (the C layout of two n-tiles is the A
// layout of one k-step), so they never touch shared memory.

typedef __nv_bfloat16 bf16;

constexpr int MMA_THREADS = 128;
constexpr int MN = 64;            // tile rows and columns
constexpr int NT = MN / 8;        // n-tiles over a tile's 64 columns
constexpr int LTT = MN + 8;       // row stride of a transposed (d x 64) tile

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
// bf16 tile with row stride ld (g = lane / 4, t = lane % 4).
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

// Rows [row0, row0 + 64) of a (rows, D) bf16 slab into shared memory:
// row-major with row stride D + 8 into dst and/or transposed with row
// stride 64 + 8 into dstT (either may be null); rows past the slab are
// zero. Each thread moves 16 bytes; consecutive threads take consecutive
// rows, so the transposed 2-byte stores do not collide on a bank.
template <int D>
__device__ __forceinline__ void stage_bf16(bf16* dst, bf16* dstT, const bf16* __restrict__ src,
                                           int row0, int rows) {
  for (int idx = threadIdx.x; idx < MN * (D / 8); idx += MMA_THREADS) {
    const int r = idx % MN, c = (idx / MN) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows)
      v = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * D + c);
    if (dst != nullptr) *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = v;
    if (dstT != nullptr) {
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i) dstT[(c + i) * LTT + r] = e[i];
    }
  }
}

// The row (q index) and column (k index) of C-fragment element e of n-tile j.
__device__ __forceinline__ int frag_row(int r0, int e) { return r0 + (e >> 1) * 8; }
__device__ __forceinline__ int frag_col(int c0, int j, int t, int e) {
  return c0 + j * 8 + 2 * t + (e & 1);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
    k2_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dq, Shape s) {
  constexpr int LS = D + 8, DT = D / 8, KS = D / 16;
  extern __shared__ __align__(16) unsigned char k2_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(k2_smem);
  bf16* dOs = Qs + MN * LS;
  bf16* Ks = dOs + MN * LS;
  bf16* Vs = Ks + MN * LS;
  bf16* Kt = Vs + MN * LS;  // D x LTT

  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = (threadIdx.x / 32) * 16;
  const int q0 = ((s.T + MN - 1) / MN - 1 - static_cast<int>(blockIdx.x)) * MN;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t qrow = (static_cast<size_t>(b) * s.Hq + h) * s.T;
  const size_t krow = (static_cast<size_t>(b) * s.Hkv + h / (s.Hq / s.Hkv)) * s.S;
  const int r0 = q0 + wr + g;

  stage_bf16<D>(Qs, nullptr, q + qrow * D, q0, s.T);
  stage_bf16<D>(dOs, nullptr, dout + qrow * D, q0, s.T);
  float L[2], Dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    L[r] = row < s.T ? lse[qrow + row] : 0.f;
    Dl[r] = row < s.T ? delta[qrow + row] : 0.f;
  }

  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int first, last;
  kv_tile_range(s, q0, MN, MN, first, last);
  for (int kt = first; kt <= last; ++kt) {
    const int k0 = kt * MN;
    __syncthreads();  // the last tile's K/V reads are done
    stage_bf16<D>(Ks, Kt, k + krow * D, k0, s.S);
    stage_bf16<D>(Vs, nullptr, v + krow * D, k0, s.S);
    __syncthreads();

    float sc[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      load_a(a, Qs, LS, wr, kk * 16, g, t);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_rows(sc[j], a, Ks, LS, j * 8, kk * 16, g, t);
      load_a(a, dOs, LS, wr, kk * 16, g, t);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_rows(dp[j], a, Vs, LS, j * 8, kk * 16, g, t);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = visible(s, frag_row(r0, e), frag_col(k0, j, t, e))
                            ? expf(sc[j][e] * s.scale - L[e >> 1])
                            : 0.f;
        sc[j][e] = p * (dp[j][e] - Dl[e >> 1]) * s.scale;  // dS
      }
#pragma unroll
    for (int kk = 0; kk < MN / 16; ++kk) {
      uint32_t da[4];
      c_to_a(da, sc[2 * kk], sc[2 * kk + 1]);  // dS rounded to bf16
#pragma unroll
      for (int n = 0; n < DT; ++n) mma_rows(acc[n], da, Kt, LTT, n * 8, kk * 16, g, t);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= s.T) continue;
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) store(dq + (qrow + row) * D + n * 8 + 2 * t + e, acc[n][2 * r + e]);
  }
}

// ---------------------------------------------------------------------------
// bf16, d in {64, 128}: the forward (K2f) and dK/dV (K2b) kernels for Hopper.
// Each CTA has two consumer warpgroups of 64 rows that run wgmma on tiles
// which TMA loads ahead of them into a ring of STAGES slots in shared
// memory: an mbarrier per slot that the copy fills, one that the consumers'
// 8 warps empty. One thread issues every load. In K2f it is the one thread
// of a producer warpgroup (warp specialisation; setmaxnreg hands the
// producer's registers to the consumers, whose code fits in the 168 that 12
// warps leave). K2b's consumers need more (dK and dV alone hold 128 fp32 a
// thread): ptxas allocated them 168 with any ninth warp, setmaxnreg or not,
// spilled and serialized the wgmma, so K2b runs 8 warps (255 registers) and
// its thread 0 refills a slot at the start of the item after the slot's last
// one, once its own warp has released it. Every tile is loaded by TMA with
// the 128-byte swizzle, as panels of 64 columns (128 bytes) by the tile's
// rows; each map views its tensor as (d, rows, B * heads), so a box past a
// head's last row reads TMA's zero fill, never the next head's rows. wgmma
// reads the panels through descriptors: K-major where d is the reduction
// (Q K^T, K Q^T, V dO^T) and MN-major where the rows are (P V, P^T dO,
// dS^T Q), so no operand is ever transposed in memory. P and dS go from the
// fp32 accumulators to bf16 A fragments in registers (the accumulator
// layout of two 8-column groups is the A layout of one 16-deep step).

namespace hop {

constexpr int WG = 128;                // threads in a warpgroup
constexpr int STAGES = 2;              // slots in the load ring
constexpr int PANEL = 64;              // bf16 columns in a 128-byte swizzled row
constexpr int CONSUMER_WARPS = 8;      // arrivals that empty a slot
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the phase of the given parity has completed. A wait that
// outlasts any real load (2^32 polls) traps, so a lost arrival fails the
// launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done, polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (++polls == 0) __trap();
  } while (!done);
}

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_1d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}

// Rows [row0, row0 + rows) of head bh, all D columns, as D / 64 swizzled
// panels of rows x 64 at dst.
template <int D>
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map, uint64_t* bar,
                                         int rows, int row0, int bh) {
#pragma unroll
  for (int p = 0; p < D / PANEL; ++p) tma_3d(dst + p * rows * PANEL, map, bar, p * PANEL, row0, bh);
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

// The A fragment of one 16-deep step from the accumulators of the two
// 8-column groups at c (c[0..3] and c[4..7]), rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float* c) {
  a[0] = pack_bf16(c[0], c[1]);
  a[1] = pack_bf16(c[2], c[3]);
  a[2] = pack_bf16(c[4], c[5]);
  a[3] = pack_bf16(c[6], c[7]);
}

// How much of the block rows [r0, r0 + nr) x columns [c0, c0 + nc) is
// visible: 0 none (skipped), 2 all (no mask), 1 some (masked per element).
__device__ __forceinline__ int block_visibility(const Shape& s, int r0, int nr, int c0, int nc) {
  const int c_hi = c0 + nc - 1;
  const int p_lo = r0 + s.q_offset, p_hi = min(r0 + nr, s.T) - 1 + s.q_offset;
  if (c0 >= s.kv_len || r0 >= s.T) return 0;
  if (s.causal && c0 > p_hi) return 0;
  if (s.window > 0 && min(c_hi, s.kv_len - 1) <= p_lo - s.window) return 0;
  const bool all = c_hi < s.kv_len && r0 + nr <= s.T && (!s.causal || c_hi <= p_lo) &&
                   (s.window <= 0 || c0 > p_hi - s.window);
  return all ? 2 : 1;
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// K2f: one CTA per (q tile of 128 rows, q head, b), q tiles longest first
// over the whole grid (blockIdx.x / (B * Hq) is the tile's rank); each
// consumer owns 64 q rows and walks the kv tiles of 128 rows: S = Q K^T
// (K-major Q and K), the online softmax, O += P V (P in registers, V
// MN-major). K and V have slots of their own, so K's refill starts as soon
// as S is read.
template <int D>
struct Fwd {
  static constexpr int THREADS = 3 * WG;  // the producer warpgroup, then two consumers
  static constexpr int BM = 128, BN = 128;
  static constexpr int Q_BYTES = BM * D * 2, KV_BYTES = BN * D * 2;
  static constexpr int K_OFF = Q_BYTES, V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + (1 + 4 * STAGES) * 8 + 1024;  // + alignment slack
};

// One tile's online softmax for this thread's two rows: masks the logits
// sc where the block is not all visible, moves the row max m (log2 units)
// and this thread's share of the row sum l, turns sc into P and returns in
// alpha the factor by which the rows' earlier output must be scaled.
template <int R>
__device__ __forceinline__ void softmax_tile(float (&sc)[R], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const Shape& s, int vis, int r0,
                                             int k0, int t, float sl2) {
  if (vis != 2) {
#pragma unroll
    for (int j = 0; j < R / 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!visible(s, r0 + (e >> 1) * 8, k0 + j * 8 + 2 * t + (e & 1))) sc[j * 4 + e] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < R / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[j * 4 + e]);
  float ms[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], quad_max(mx[r]) * sl2);
    ms[r] = mn == -INFINITY ? 0.f : mn;
    alpha[r] = exp2f(m[r] - ms[r]);
    m[r] = mn;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < R / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(fmaf(sc[j * 4 + e], sl2, -ms[e >> 1]));
      l[e >> 1] += p;  // this thread's columns; the quad's sum is taken at the end
      sc[j * 4 + e] = p;
    }
}

template <int D>
__global__ void __launch_bounds__(Fwd<D>::THREADS, 1)
    k2_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ out,
                        float* __restrict__ lse, Shape s) {
  using L = Fwd<D>;
  constexpr int NS = L::BN / 8;  // 8-column groups of S
  extern __shared__ unsigned char k2_raw[];
  unsigned char* base = align_1024(k2_raw);
  bf16* Qs = reinterpret_cast<bf16*>(base);
  bf16* Ks = reinterpret_cast<bf16*>(base + L::K_OFF);
  bf16* Vs = reinterpret_cast<bf16*>(base + L::V_OFF);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + L::BAR_OFF);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;

  const int heads = s.B * s.Hq;
  const int hb = blockIdx.x % heads;
  const int h = hb % s.Hq, b = hb / s.Hq;
  const int q0 = ((s.T + L::BM - 1) / L::BM - 1 - static_cast<int>(blockIdx.x) / heads) * L::BM;
  int first, last;
  kv_tile_range(s, q0, L::BM, L::BN, first, last);
  const int n = last - first + 1;  // kv tiles in the loop

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&k_full[i], 1);
      mbar_init(&v_full[i], 1);
      mbar_init(&k_empty[i], CONSUMER_WARPS);
      mbar_init(&v_empty[i], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index, broadcast from lane 0 so the compiler sees it is
  // uniform across each warp
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / WG, 0);
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      const int kvh = b * s.Hkv + h / (s.Hq / s.Hkv);
      mbar_expect_tx(q_full, L::Q_BYTES);
      tma_tile<D>(Qs, &qmap, q_full, L::BM, q0, hb);
      for (int i = 0; i < n; ++i) {
        const int st = i % STAGES, k0 = (first + i) * L::BN;
        const uint32_t free = ((i / STAGES) & 1) ^ 1;  // the slot's last use released
        mbar_wait(&k_empty[st], free);
        mbar_expect_tx(&k_full[st], L::KV_BYTES);
        tma_tile<D>(Ks + st * L::BN * D, &kmap, &k_full[st], L::BN, k0, kvh);
        mbar_wait(&v_empty[st], free);
        mbar_expect_tx(&v_full[st], L::KV_BYTES);
        tma_tile<D>(Vs + st * L::BN * D, &vmap, &v_full[st], L::BN, k0, kvh);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1, tid = threadIdx.x % WG, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int qw0 = q0 + cw * 64;              // this consumer's first q row
    const int r0 = qw0 + (tid / 32) * 16 + g;  // this thread's rows: r0 and r0 + 8
    const float sl2 = s.scale * LOG2E;         // logits in log2 units
    const uint64_t qd = desc(Qs + cw * 64 * PANEL, 16, 1024);
    float o[D / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    mbar_wait(q_full, 0);
    for (int i = 0; i < n; ++i) {
      const int st = i % STAGES, k0 = (first + i) * L::BN;
      const uint32_t ph = (i / STAGES) & 1;
      float sc[NS * 4];
      const uint64_t kd = desc(Ks + st * L::BN * D, 16, 1024);
      mbar_wait(&k_full[st], ph);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<L::BN>::ss(sc, qd, kstep(kk, L::BM), kd, kstep(kk, L::BN), kk);
      wg_commit();
      wg_wait<0>();
      pin(sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&k_empty[st]);  // K is read: its slot may refill
      softmax_tile(sc, m, l, alpha, s, block_visibility(s, qw0, 64, k0, L::BN), r0, k0, t,
                   sl2);
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        o[4 * c] *= alpha[0];
        o[4 * c + 1] *= alpha[0];
        o[4 * c + 2] *= alpha[1];
        o[4 * c + 3] *= alpha[1];
      }
      uint32_t pa[NS / 2][4];
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) pack_a(pa[kk], sc + 8 * kk);  // P rounded to bf16
      const uint64_t vd = desc(Vs + st * L::BN * D, L::BN * PANEL * 2, 1024);
      mbar_wait(&v_full[st], ph);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) Wgmma<D>::rs(o, pa[kk], vd, mnstep(kk));
      wg_commit();
      wg_wait<0>();
      pin(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&v_empty[st]);
    }
    const size_t qrow = static_cast<size_t>(hb) * s.T;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      const float lr = quad_sum(l[r]);
      if (row >= s.T) continue;
      const float inv = lr == 0.f ? 0.f : 1.f / lr;
      bf16* dst = out + (qrow + row) * D + 2 * t;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(dst + c * 8) =
            __floats2bfloat162_rn(o[4 * c + 2 * r] * inv, o[4 * c + 2 * r + 1] * inv);
      if (t == 0) lse[qrow + row] = lr == 0.f ? NEG : m[r] * LN2 + logf(lr);
    }
  }
}

// K2b: one CTA per (k tile of 128 rows, kv head, b), k tiles longest first
// over the whole grid; each consumer owns 64 k rows, holds K and V for them
// (loaded once) and its dK and dV in fp32 registers across the loop over
// the group's G query heads and the q tiles of 64 rows that see the k tile.
// Thread 0 streams Q, dO, lse and delta per q tile. For each tile:
// S^T = K Q^T and dP^T = V dO^T (K-major Q and dO), P^T = exp(S^T - lse),
// dS^T = P^T (dP^T - delta) scale, then dV += P^T dO and dK += dS^T Q with
// P^T and dS^T as bf16 register A operands and dO, Q as MN-major B. P^T
// is computed while dP^T's wgmma runs.
template <int D>
struct Dkdv {
  static constexpr int THREADS = 2 * WG;   // two warpgroups; thread 0 also issues the loads
  static constexpr int BM = 64, BN = 128;  // q rows a step, k rows a CTA
  static constexpr int KV_BYTES = BN * D * 2, Q_BYTES = BM * D * 2;
  static constexpr int STAGE = 2 * Q_BYTES + 1024;  // Q, dO, lse, delta (and alignment)
  static constexpr int STAGE_TX = 2 * Q_BYTES + 2 * BM * 4;
  static constexpr int V_OFF = KV_BYTES, RING_OFF = 2 * KV_BYTES;
  static constexpr int BAR_OFF = RING_OFF + STAGES * STAGE;
  static constexpr int SMEM = BAR_OFF + (1 + 2 * STAGES) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(Dkdv<D>::THREADS, 1)
    k2_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap domap,
                         const __grid_constant__ CUtensorMap lsemap,
                         const __grid_constant__ CUtensorMap deltamap, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, Shape s) {
  using L = Dkdv<D>;
  extern __shared__ unsigned char k2_raw[];
  unsigned char* base = align_1024(k2_raw);
  bf16* Ks = reinterpret_cast<bf16*>(base);
  bf16* Vs = reinterpret_cast<bf16*>(base + L::V_OFF);
  unsigned char* ring = base + L::RING_OFF;  // per slot: Q, dO, lse, delta
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(base + L::BAR_OFF);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int heads = s.B * s.Hkv;
  const int hb = blockIdx.x % heads;  // b * Hkv + kv head
  const int k0 = static_cast<int>(blockIdx.x) / heads * L::BN;
  const int G = s.Hq / s.Hkv;
  int first, last;
  q_tile_range(s, k0, L::BM, L::BN, first, last);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Item i of the loop: query head gi = i / nq of the group, q tile
  // first + i % nq. Thread 0 issues every load; it refills a slot at the
  // start of item i, after its own warp released the slot's item i - 1.
  const int nq = max(last - first + 1, 0), items = G * nq;
  auto load_item = [&](int i) {
    const int st = i % STAGES, qt = first + i % nq;
    const int qh = (hb / s.Hkv) * s.Hq + (hb % s.Hkv) * G + i / nq;  // b * Hq + q head
    unsigned char* slot = ring + st * L::STAGE;
    bf16* q = reinterpret_cast<bf16*>(slot);
    if (i >= STAGES) mbar_wait(&empty[st], ((i / STAGES) & 1) ^ 1);
    mbar_expect_tx(&full[st], L::STAGE_TX);
    tma_tile<D>(q, &qmap, &full[st], L::BM, qt * L::BM, qh);
    tma_tile<D>(q + L::BM * D, &domap, &full[st], L::BM, qt * L::BM, qh);
    tma_1d(slot + 2 * L::Q_BYTES, &lsemap, &full[st], qh * s.T + qt * L::BM);
    tma_1d(slot + 2 * L::Q_BYTES + 512, &deltamap, &full[st], qh * s.T + qt * L::BM);
  };
  const bool loader = threadIdx.x == 0;
  if (loader) {
    mbar_expect_tx(kv_full, 2 * L::KV_BYTES);
    tma_tile<D>(Ks, &kmap, kv_full, L::BN, k0, hb);
    tma_tile<D>(Vs, &vmap, kv_full, L::BN, k0, hb);
    for (int i = 0; i < min(items, STAGES); ++i) load_item(i);
  }
  __syncwarp();

  const int cw = threadIdx.x / WG, tid = threadIdx.x % WG, lane = tid % 32, g = lane / 4,
            t = lane % 4;
  const int kw0 = k0 + cw * 64;              // this consumer's first k row
  const int r0 = kw0 + (tid / 32) * 16 + g;  // this thread's k rows: r0 and r0 + 8
  const float sl2 = s.scale * LOG2E;
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  const uint64_t kd = desc(Ks + cw * 64 * PANEL, 16, 1024);
  const uint64_t vd = desc(Vs + cw * 64 * PANEL, 16, 1024);
  mbar_wait(kv_full, 0);
  for (int i = 0; i < items; ++i) {
    if (loader && i >= 1 && i + STAGES - 1 < items) load_item(i + STAGES - 1);
    __syncwarp();
    const int qt = first + i % nq;
    const int st = i % STAGES;
    const int q0 = qt * L::BM;
    const unsigned char* slot = ring + st * L::STAGE;
    const bf16* qs = reinterpret_cast<const bf16*>(slot);
    const bf16* dos = qs + L::BM * D;
    const float* ls = reinterpret_cast<const float*>(slot + 2 * L::Q_BYTES);
    const float* dls = ls + 128;
    const int vis = block_visibility(s, q0, L::BM, kw0, 64);
    mbar_wait(&full[st], (i / STAGES) & 1);
    if (vis != 0) {
      float sc[32], dp[32];  // S^T and dP^T: k rows x 64 q columns
      const uint64_t qd = desc(qs, 16, 1024), dod = desc(dos, 16, 1024);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<64>::ss(sc, kd, kstep(kk, L::BN), qd, kstep(kk, L::BM), kk);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<64>::ss(dp, vd, kstep(kk, L::BN), dod, kstep(kk, L::BM), kk);
      wg_commit();
      wg_wait<1>();  // S^T is in; P^T is computed while dP^T runs
      pin(sc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 lv = *reinterpret_cast<const float2*>(ls + j * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1);  // q column in the tile
          const bool on = vis == 2 || visible(s, q0 + c, r0 + (e >> 1) * 8);
          const float lse2 = ((e & 1) ? lv.y : lv.x) * LOG2E;
          sc[j * 4 + e] = on ? exp2f(fmaf(sc[j * 4 + e], sl2, -lse2)) : 0.f;
        }
      }
      wg_wait<0>();
      pin(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(dls + j * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)  // dS^T
          dp[j * 4 + e] = sc[j * 4 + e] * (dp[j * 4 + e] - ((e & 1) ? dl.y : dl.x)) * s.scale;
      }
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pack_a(pa[kk], sc + 8 * kk);  // P^T rounded to bf16
        pack_a(da[kk], dp + 8 * kk);  // dS^T rounded to bf16
      }
      const uint64_t dom = desc(dos, L::BM * PANEL * 2, 1024);
      const uint64_t qm = desc(qs, L::BM * PANEL * 2, 1024);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) Wgmma<D>::rs(dva, pa[kk], dom, mnstep(kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) Wgmma<D>::rs(dka, da[kk], qm, mnstep(kk));
      wg_commit();
      wg_wait<0>();
      pin(dva);
      pin(dka);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }
  const size_t krow = static_cast<size_t>(hb) * s.S;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= s.S) continue;
    bf16* dkp = dk + (krow + row) * D + 2 * t;
    bf16* dvp = dv + (krow + row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + n * 8) =
          __floats2bfloat162_rn(dka[4 * n + 2 * r], dka[4 * n + 2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvp + n * 8) =
          __floats2bfloat162_rn(dva[4 * n + 2 * r], dva[4 * n + 2 * r + 1]);
    }
  }
}

// Encodes TMA maps through the driver's cuTensorMapEncodeTiled, found at
// run time with cudaGetDriverEntryPoint so the library links no libcuda.
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A (d, rows, heads) bf16 view of a contiguous (heads, rows, d) tensor,
// boxes of 64 columns x box_rows rows of one head, 128-byte swizzle.
int map_rows(CUtensorMap* m, const void* ptr, int d, int rows, int heads, int box_rows) {
  const auto fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(rows) * d * 2};
  const cuuint32_t box[3] = {PANEL, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : static_cast<int>(cudaErrorInvalidValue);
}

// A flat fp32 view of n values, boxes of 64; past n reads zeros.
int map_flat(CUtensorMap* m, const void* ptr, size_t n) {
  const auto fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {0};
  const cuuint32_t box[1] = {64};
  const cuuint32_t elem[1] = {1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace hop

template <int D>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* out, void* lse, Shape s,
                     cudaStream_t st) {
  using L = hop::Fwd<D>;
  CUtensorMap qm, km, vm;
  int e;
  if ((e = hop::map_rows(&qm, q, D, s.T, s.B * s.Hq, L::BM)) ||
      (e = hop::map_rows(&km, k, D, s.S, s.B * s.Hkv, L::BN)) ||
      (e = hop::map_rows(&vm, v, D, s.S, s.B * s.Hkv, L::BN)))
    return e;
  cudaError_t err = cudaFuncSetAttribute(hop::k2_fwd_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  const int grid = (s.T + L::BM - 1) / L::BM * s.Hq * s.B;
  hop::k2_fwd_wgmma_kernel<D><<<grid, L::THREADS, L::SMEM, st>>>(
      qm, km, vm, static_cast<bf16*>(out), static_cast<float*>(lse), s);
  return cudaGetLastError();
}

template <int D>
int launch_dkdv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dk, void* dv, Shape s,
                      cudaStream_t st) {
  using L = hop::Dkdv<D>;
  CUtensorMap qm, km, vm, dom, lm, dm;
  const size_t rows = static_cast<size_t>(s.B) * s.Hq * s.T;
  int e;
  if ((e = hop::map_rows(&qm, q, D, s.T, s.B * s.Hq, L::BM)) ||
      (e = hop::map_rows(&dom, dout, D, s.T, s.B * s.Hq, L::BM)) ||
      (e = hop::map_rows(&km, k, D, s.S, s.B * s.Hkv, L::BN)) ||
      (e = hop::map_rows(&vm, v, D, s.S, s.B * s.Hkv, L::BN)) ||
      (e = hop::map_flat(&lm, lse, rows)) || (e = hop::map_flat(&dm, delta, rows)))
    return e;
  cudaError_t err = cudaFuncSetAttribute(hop::k2_dkdv_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  const int grid = (s.S + L::BN - 1) / L::BN * s.Hkv * s.B;
  hop::k2_dkdv_wgmma_kernel<D><<<grid, L::THREADS, L::SMEM, st>>>(
      qm, km, vm, dom, lm, dm, static_cast<bf16*>(dk), static_cast<bf16*>(dv), s);
  return cudaGetLastError();
}

template <int D>
constexpr size_t dq_mma_smem() {
  return (4 * MN * (D + 8) + D * LTT) * sizeof(bf16);
}
template <int D>
constexpr size_t fwd_smem() {
  return (3 * Tile<D>::N * Tile<D>::LD + Tile<D>::N * Tile<D>::LP) * sizeof(float);
}
template <int D>
constexpr size_t dkdv_smem() {
  return (4 * Tile<D>::N * Tile<D>::LD + 2 * Tile<D>::N * Tile<D>::LP + 2 * Tile<D>::N) *
         sizeof(float);
}
template <int D>
constexpr size_t dq_smem() {
  return (4 * Tile<D>::N * Tile<D>::LD + Tile<D>::N * Tile<D>::LP + 2 * Tile<D>::N) *
         sizeof(float);
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse, Shape s,
               cudaStream_t st) {
  constexpr size_t smem = fwd_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(k2_fwd_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((s.T + Tile<D>::N - 1) / Tile<D>::N, s.Hq, s.B);
  k2_fwd_kernel<T, D><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), s);
  return cudaGetLastError();
}

template <typename T, int D>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                const void* delta, void* dk, void* dv, Shape s, cudaStream_t st) {
  constexpr size_t smem = dkdv_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(k2_dkdv_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((s.S + Tile<D>::N - 1) / Tile<D>::N, s.Hkv, s.B);
  k2_dkdv_kernel<T, D><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), s);
  return cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, Shape s, cudaStream_t st) {
  constexpr size_t smem = dq_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(k2_dq_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((s.T + Tile<D>::N - 1) / Tile<D>::N, s.Hq, s.B);
  k2_dq_kernel<T, D><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), s);
  return cudaGetLastError();
}

template <int D>
int launch_dq_mma(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dq, Shape s, cudaStream_t st) {
  constexpr size_t smem = dq_mma_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(k2_dq_mma_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((s.T + MN - 1) / MN, s.Hq, s.B);
  k2_dq_mma_kernel<D><<<grid, MMA_THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), s);
  return cudaGetLastError();
}

Shape make_shape(int B, int Hq, int Hkv, int T, int S, int kv_len, int q_offset, int causal,
                 int window, float scale) {
  return Shape{B, Hq, Hkv, T, S, kv_len, q_offset, causal, window, scale};
}

}  // namespace

// Runs the kernel of the design the caller names for (dtype, d). design 1,
// the tensor cores, takes bf16 with d in {64, 128}: K2f and K2b on wgmma
// with TMA (hop::), K2q on mma.sync. design 0, FMA, takes fp32 (which the
// bf16 tensor cores cannot hold to fp32 accuracy) with d in {64, 128, 256}
// and bf16 with d = 256 (whose accumulators do not fit the tensor-core
// kernels' registers). Any other combination is refused.
#define K2_DISPATCH(TC, FMA, ...)                                                      \
  do {                                                                                 \
    if (design == 1 && is_bf16) {                                                      \
      if (d == 64) return TC<64>(__VA_ARGS__);                                         \
      if (d == 128) return TC<128>(__VA_ARGS__);                                       \
    } else if (design == 0 && is_bf16) {                                               \
      if (d == 256) return FMA<__nv_bfloat16, 256>(__VA_ARGS__);                       \
    } else if (design == 0) {                                                          \
      if (d == 64) return FMA<float, 64>(__VA_ARGS__);                                 \
      if (d == 128) return FMA<float, 128>(__VA_ARGS__);                               \
      if (d == 256) return FMA<float, 256>(__VA_ARGS__);                               \
    }                                                                                  \
    return static_cast<int>(cudaErrorInvalidValue);                                    \
  } while (0)

extern "C" int k2_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                            int B, int Hq, int Hkv, int T, int S, int d, int kv_len,
                            int q_offset, int causal, int window, float scale, int is_bf16,
                            int design, void* stream) {
  const Shape s = make_shape(B, Hq, Hkv, T, S, kv_len, q_offset, causal, window, scale);
  K2_DISPATCH(launch_fwd_wgmma, launch_fwd, q, k, v, out, lse, s,
              static_cast<cudaStream_t>(stream));
}

extern "C" int k2_flash_dkdv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int B,
                             int Hq, int Hkv, int T, int S, int d, int kv_len, int q_offset,
                             int causal, int window, float scale, int is_bf16, int design,
                             void* stream) {
  const Shape s = make_shape(B, Hq, Hkv, T, S, kv_len, q_offset, causal, window, scale);
  K2_DISPATCH(launch_dkdv_wgmma, launch_dkdv, q, k, v, dout, lse, delta, dk, dv, s,
              static_cast<cudaStream_t>(stream));
}

extern "C" int k2_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dq, int B, int Hq, int Hkv,
                           int T, int S, int d, int kv_len, int q_offset, int causal,
                           int window, float scale, int is_bf16, int design, void* stream) {
  const Shape s = make_shape(B, Hq, Hkv, T, S, kv_len, q_offset, causal, window, scale);
  K2_DISPATCH(launch_dq_mma, launch_dq, q, k, v, dout, lse, delta, dq, s, static_cast<cudaStream_t>(stream));
}
