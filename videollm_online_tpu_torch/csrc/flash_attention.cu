// K2: flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the three TPU kernels of videollm_online_tpu/ops/flash_attention.py:
// _flash_fwd (_fwd_kernel), and the two kernels of _flash_bwd (_dkdv_kernel
// and _dq_kernel).
//
// What it computes. q (B, Hq, T, d) attends k/v (B, Hkv, S, d); the G =
// Hq / Hkv query heads of a kv head share its K/V. Slot `col` is visible to
// query `row` iff col < kv_len, row < T and, when causal, col <= row +
// q_offset and, with a window, col > row + q_offset - window. Logits and the
// softmax are fp32; probabilities are rounded to the input dtype before every
// product with V or dO, and dS before every product with Q or K, as the TPU
// kernels round them. The forward writes out (input dtype) and the row
// log-sum-exp lse (fp32). A row that sees no slot outputs 0 with lse -1e30
// (on the TPU such a row's value depends on its block size). The backward
// recomputes P = exp(S - lse) and uses delta = rowsum(dO * O), which the
// wrapper computes.
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
// Causal q tiles run last-first (blockIdx.x 0 is the longest row range) and
// k tiles first-first, so the longest CTAs start in the first wave.
//
// Two implementations, picked by the input: bf16 with d <= 128 (the
// training path) runs on the tensor cores with mma.sync m16n8k16 (bf16 in,
// fp32 accumulate), 4 warps per CTA, each warp owning 16 rows of a 64 x 64
// tile; P and dS go from the accumulators to the next product's A operand in
// registers. fp32 (which bf16 tensor cores cannot hold to fp32 accuracy) and
// bf16 with d = 256 (whose accumulators do not fit those registers) run on
// the CUDA cores with fp32 FMA: 256 threads as 16 x 16, tiles N x N with
// N = 64 (d <= 128) or 32 (d = 256) staged as fp32 with a row stride of
// d + 1, each thread holding (N/16) x (N/16) of S and (N/16) rows x (d/16)
// columns of each accumulator.
//
// Bound. At the training shapes attention is bound by operations: a causal
// forward at B 1, Hq 32, T 4096, d 128 is ~137 GFLOP against ~84 MB moved.
// mma.sync from registers and shared memory, without TMA, wgmma or a load
// pipeline, reaches a fraction of the tensor cores' rate; wgmma/TMA are
// later work.

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

// The kv tiles [first, last] that some row of the q tile at q0 can see.
template <int N>
__device__ __forceinline__ void kv_tiles(const Shape& s, int q0, int& first, int& last) {
  last = (s.kv_len + N - 1) / N - 1;
  if (s.causal) last = min(last, (min(q0 + N, s.T) - 1 + s.q_offset) / N);
  first = 0;
  if (s.window > 0) {
    const int lo = q0 + s.q_offset - s.window + 1;
    first = lo > 0 ? lo / N : 0;
  }
}

// The q tiles [first, last] with some row that sees a column of the k tile at k0.
template <int N>
__device__ __forceinline__ void q_tiles(const Shape& s, int k0, int& first, int& last) {
  first = 0;
  last = (s.T + N - 1) / N - 1;
  if (k0 >= s.kv_len) {
    last = -1;
    return;
  }
  if (s.causal) {
    const int lo = k0 - s.q_offset;
    first = lo > 0 ? lo / N : 0;
  }
  if (s.window > 0) {
    const int hi = k0 + N - 1 - s.q_offset + s.window - 1;
    if (hi < 0) {
      last = -1;
      return;
    }
    last = min(last, hi / N);
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
  kv_tiles<N>(s, q0, first, last);
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
  q_tiles<N>(s, k0, first, last);
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
  kv_tiles<N>(s, q0, first, last);
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
    k2_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      float* __restrict__ lse, Shape s) {
  constexpr int LS = D + 8, DT = D / 8, KS = D / 16;
  extern __shared__ __align__(16) unsigned char k2_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(k2_smem);
  bf16* Ks = Qs + MN * LS;
  bf16* Vt = Ks + MN * LS;  // D x LTT

  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = (threadIdx.x / 32) * 16;  // the warp's first row in the tile
  const int q0 = ((s.T + MN - 1) / MN - 1 - static_cast<int>(blockIdx.x)) * MN;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t qrow = (static_cast<size_t>(b) * s.Hq + h) * s.T;
  const size_t krow = (static_cast<size_t>(b) * s.Hkv + h / (s.Hq / s.Hkv)) * s.S;
  const int r0 = q0 + wr + g;  // this thread's rows: r0 and r0 + 8

  stage_bf16<D>(Qs, nullptr, q + qrow * D, q0, s.T);
  __syncthreads();
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) load_a(qa[kk], Qs, LS, wr, kk * 16, g, t);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, o[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  int first, last;
  kv_tiles<MN>(s, q0, first, last);
  for (int kt = first; kt <= last; ++kt) {
    const int k0 = kt * MN;
    __syncthreads();  // the last tile's K/V reads are done
    stage_bf16<D>(Ks, nullptr, k + krow * D, k0, s.S);
    stage_bf16<D>(nullptr, Vt, v + krow * D, k0, s.S);
    __syncthreads();

    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_rows(sc[j], qa[kk], Ks, LS, j * 8, kk * 16, g, t);

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = visible(s, frag_row(r0, e), frag_col(k0, j, t, e)) ? sc[j][e] * s.scale
                                                                            : -INFINITY;
        sc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float m_new[2], alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = m_new[r] == -INFINITY ? 1.f : expf(m[r] - m_new[r]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = sc[j][e] == -INFINITY ? 0.f : expf(sc[j][e] - m_new[e >> 1]);
        ps[e >> 1] += p;
        sc[j][e] = p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * alpha[r] + quad_sum(ps[r]);
      m[r] = m_new[r];
    }
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < MN / 16; ++kk) {
      uint32_t pa[4];
      c_to_a(pa, sc[2 * kk], sc[2 * kk + 1]);  // P rounded to bf16
#pragma unroll
      for (int n = 0; n < DT; ++n) mma_rows(o[n], pa, Vt, LTT, n * 8, kk * 16, g, t);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= s.T) continue;
    bf16* dst = out + (qrow + row) * D;
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        store(dst + n * 8 + 2 * t + e, l[r] == 0.f ? 0.f : o[n][2 * r + e] / l[r]);
    if (t == 0) lse[qrow + row] = l[r] == 0.f ? NEG : m[r] + logf(l[r]);
  }
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
  kv_tiles<MN>(s, q0, first, last);
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

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
    k2_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, Shape s) {
  constexpr int LS = D + 8, DT = D / 8, KS = D / 16, HALF = NT / 2;
  extern __shared__ __align__(16) unsigned char k2_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(k2_smem);
  bf16* Vs = Ks + MN * LS;
  bf16* Qs = Vs + MN * LS;
  bf16* dOs = Qs + MN * LS;
  bf16* Qt = dOs + MN * LS;   // D x LTT
  bf16* dOt = Qt + D * LTT;   // D x LTT
  float* Ls = reinterpret_cast<float*>(dOt + D * LTT);
  float* Dls = Ls + MN;

  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = (threadIdx.x / 32) * 16;  // the warp's first k row in the tile
  const int k0 = blockIdx.x * MN;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = s.Hq / s.Hkv;
  const size_t krow = (static_cast<size_t>(b) * s.Hkv + hk) * s.S;
  const int kr0 = k0 + wr + g;  // this thread's k rows: kr0 and kr0 + 8

  stage_bf16<D>(Ks, nullptr, k + krow * D, k0, s.S);
  stage_bf16<D>(Vs, nullptr, v + krow * D, k0, s.S);

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  int first, last;
  q_tiles<MN>(s, k0, first, last);
  for (int gi = 0; gi < G; ++gi) {
    const size_t qrow = (static_cast<size_t>(b) * s.Hq + hk * G + gi) * s.T;
    for (int qt = first; qt <= last; ++qt) {
      const int q0 = qt * MN;
      __syncthreads();  // the last tile's Q/dO reads are done
      stage_bf16<D>(Qs, Qt, q + qrow * D, q0, s.T);
      stage_bf16<D>(dOs, dOt, dout + qrow * D, q0, s.T);
      load_rows<MN>(Ls, lse + qrow, q0, s.T);
      load_rows<MN>(Dls, delta + qrow, q0, s.T);
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T, one half of the q columns at a time
      // (not unrolled: both halves live at once would spill)
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        float st[HALF][4], dpt[HALF][4];
#pragma unroll
        for (int j = 0; j < HALF; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t a[4];
          load_a(a, Ks, LS, wr, kk * 16, g, t);
#pragma unroll
          for (int j = 0; j < HALF; ++j)
            mma_rows(st[j], a, Qs, LS, (half * HALF + j) * 8, kk * 16, g, t);
          load_a(a, Vs, LS, wr, kk * 16, g, t);
#pragma unroll
          for (int j = 0; j < HALF; ++j)
            mma_rows(dpt[j], a, dOs, LS, (half * HALF + j) * 8, kk * 16, g, t);
        }
#pragma unroll
        for (int j = 0; j < HALF; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = frag_col(half * HALF * 8, j, t, e);  // q column in the tile
            const float p = visible(s, q0 + c, frag_row(kr0, e))
                                ? expf(st[j][e] * s.scale - Ls[c])
                                : 0.f;
            st[j][e] = p;
            dpt[j][e] = p * (dpt[j][e] - Dls[c]) * s.scale;  // dS^T
          }
        // dV += P^T dO and dK += dS^T Q over this half's 32 q rows
#pragma unroll
        for (int kk = 0; kk < HALF / 2; ++kk) {
          const int c = half * HALF * 8 + kk * 16;
          uint32_t pa[4], da[4];
          c_to_a(pa, st[2 * kk], st[2 * kk + 1]);
          c_to_a(da, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
          for (int n = 0; n < DT; ++n) {
            mma_rows(dva[n], pa, dOt, LTT, n * 8, c, g, t);
            mma_rows(dka[n], da, Qt, LTT, n * 8, c, g, t);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kr0 + 8 * r;
    if (row >= s.S) continue;
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        store(dk + (krow + row) * D + n * 8 + 2 * t + e, dka[n][2 * r + e]);
        store(dv + (krow + row) * D + n * 8 + 2 * t + e, dva[n][2 * r + e]);
      }
  }
}

template <int D>
constexpr size_t fwd_mma_smem() {
  return (2 * MN * (D + 8) + D * LTT) * sizeof(bf16);
}
template <int D>
constexpr size_t dq_mma_smem() {
  return (4 * MN * (D + 8) + D * LTT) * sizeof(bf16);
}
template <int D>
constexpr size_t dkdv_mma_smem() {
  return (4 * MN * (D + 8) + 2 * D * LTT) * sizeof(bf16) + 2 * MN * sizeof(float);
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
int launch_fwd_mma(const void* q, const void* k, const void* v, void* out, void* lse, Shape s,
                   cudaStream_t st) {
  constexpr size_t smem = fwd_mma_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(k2_fwd_mma_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((s.T + MN - 1) / MN, s.Hq, s.B);
  k2_fwd_mma_kernel<D><<<grid, MMA_THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), s);
  return cudaGetLastError();
}

template <int D>
int launch_dkdv_mma(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv, Shape s,
                    cudaStream_t st) {
  constexpr size_t smem = dkdv_mma_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(k2_dkdv_mma_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((s.S + MN - 1) / MN, s.Hkv, s.B);
  k2_dkdv_mma_kernel<D><<<grid, MMA_THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), s);
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

// Picks the kernel for (dtype, d): bf16 with d <= 128 runs on the tensor
// cores; fp32 (which the bf16 tensor cores cannot hold to fp32 accuracy)
// and bf16 with d = 256 (whose accumulators do not fit the mma kernels'
// registers) take the FMA kernels.
#define K2_DISPATCH(LAUNCH, ...)                                                       \
  do {                                                                                 \
    if (is_bf16) {                                                                     \
      if (d == 64) return LAUNCH##_mma<64>(__VA_ARGS__);                               \
      if (d == 128) return LAUNCH##_mma<128>(__VA_ARGS__);                             \
      if (d == 256) return LAUNCH<__nv_bfloat16, 256>(__VA_ARGS__);                    \
    } else {                                                                           \
      if (d == 64) return LAUNCH<float, 64>(__VA_ARGS__);                              \
      if (d == 128) return LAUNCH<float, 128>(__VA_ARGS__);                            \
      if (d == 256) return LAUNCH<float, 256>(__VA_ARGS__);                            \
    }                                                                                  \
    return static_cast<int>(cudaErrorInvalidValue);                                    \
  } while (0)

extern "C" int k2_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                            int B, int Hq, int Hkv, int T, int S, int d, int kv_len,
                            int q_offset, int causal, int window, float scale, int is_bf16,
                            void* stream) {
  const Shape s = make_shape(B, Hq, Hkv, T, S, kv_len, q_offset, causal, window, scale);
  K2_DISPATCH(launch_fwd, q, k, v, out, lse, s, static_cast<cudaStream_t>(stream));
}

extern "C" int k2_flash_dkdv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int B,
                             int Hq, int Hkv, int T, int S, int d, int kv_len, int q_offset,
                             int causal, int window, float scale, int is_bf16, void* stream) {
  const Shape s = make_shape(B, Hq, Hkv, T, S, kv_len, q_offset, causal, window, scale);
  K2_DISPATCH(launch_dkdv, q, k, v, dout, lse, delta, dk, dv, s,
              static_cast<cudaStream_t>(stream));
}

extern "C" int k2_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dq, int B, int Hq, int Hkv,
                           int T, int S, int d, int kv_len, int q_offset, int causal,
                           int window, float scale, int is_bf16, void* stream) {
  const Shape s = make_shape(B, Hq, Hkv, T, S, kv_len, q_offset, causal, window, scale);
  K2_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, s, static_cast<cudaStream_t>(stream));
}
