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
// the probabilities (V); no dequantized tile is ever formed in device
// memory. Probabilities are rounded to q's dtype before P.V, as the TPU
// kernel rounds them. A row with nothing visible outputs 0.
//
// Bound. Per layer it must read 2 * Hkv * valid * d * sizeof(kv) bytes of
// K/V (plus 2 * Hkv * valid * 4 bytes of scales for int8 K/V), and does
// 4 * Hq * S * valid * d flops. At S <= 64 (the kernel's limit, the JAX
// package's dispatch rule) that stays below the card's ~295 flops per byte
// at S <= 20 and nears it at S = 64. Tiles past the last visible slot, and
// tiles wholly below the window, are never read: the traffic is O(valid),
// not O(C).
//
// The 8-program problem. The TPU grid is (B, Hkv, kv blocks) with the kv
// axis run in order, so at B = 1 only B * Hkv = 8 programs run in parallel.
// Here the visible tiles of each stream are split evenly across `nsplit`
// CTAs (flash-decoding), sized by the wrapper to fill the card's SMs; each
// CTA finds its range from q_pos on the device, so no host sync sizes the
// split. The kernels are attention_common.cuh's, over RingPool: bf16 q with
// d in {64, 128} (every main path) runs the tensor-core design (a 3-stage
// cp.async ring of 64-slot tiles shared by the CTA's rows: wgmma on two
// warpgroups of 64 rows, or mma.sync warps that split each tile's slots
// for 16 rows or fewer, as at S = 1 with G = 4; split partials merged by
// decode_merge_kernel); fp32 q and d = 256 run the FMA design
// (fma_split_kernel, then decode_merge_kernel).

#include "attention_common.cuh"

namespace {

// Where one stream's K/V rows live: slot j of (b, h) is row ((layer * B +
// b) * Hkv + h) * C + j, in rows of d elements (and, for the scale rings,
// in elements).
struct RingPool {
  int B, Hkv, C, layer;

  struct Stream {
    size_t head;
    // every tile's slots are consecutive rows
    __device__ __forceinline__ bool contiguous() const { return true; }
    __device__ __forceinline__ size_t at(int slot) const { return head + slot; }
  };

  __device__ __forceinline__ int slots() const { return C; }
  __device__ __forceinline__ Stream stream(int b, int h) const {
    return Stream{((static_cast<size_t>(layer) * B + b) * Hkv + h) * C};
  }
};

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16. kv_int8: 0 = K/V have q's dtype,
// 1 = int8 codes with fp32 (L, B, Hkv, C) scales. window <= 0: no window.
// design, slices, part_acc and part_ml as for run() in
// attention_common.cuh. Returns cudaGetLastError() after the launches.
extern "C" int k1_ring_decode_attention(
    const void* q, const void* k_all, const void* v_all, const void* k_scale,
    const void* v_scale, const void* q_pos, void* out, void* part_acc, void* part_ml, int B,
    int Hkv, int S, int rows, int d, int C, int layer, int window, int nsplit, int q_dtype,
    int kv_int8, int design, int slices, void* stream) {
  return run(design, q_dtype, kv_int8, d, slices, q, k_all, v_all, k_scale, v_scale, q_pos, out,
             part_acc, part_ml, B, RingPool{B, Hkv, C, layer}, Args{Hkv, S, rows, window, nsplit},
             static_cast<cudaStream_t>(stream));
}
