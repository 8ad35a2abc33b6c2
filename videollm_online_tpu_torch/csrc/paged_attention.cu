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
// probabilities (V); no dequantized tile is ever formed in device memory.
// Probabilities are rounded to q's dtype before P.V, as the TPU kernel
// rounds them. A row with nothing visible outputs 0.
//
// Bound. The serving loop calls this for every paged forward: a 1-token
// decode, a 20-token spec verify, a 91-token chunk ingest and a 128-token
// prompt. Each must read every visible slot's K and V once: 2 * Hkv * d *
// sizeof(kv) bytes a slot (plus 8 bytes of scales for int8), and does
// 4 * Hq * S * d flops a slot. At S <= 20 that is far below the card's
// ~295 flops per byte, so decode and verify are bound by bytes; at S = 91
// and 128 with bf16 K/V (364 and 512 rows a kv head at G = 4) the bound is
// operations on the tensor cores.
//
// Design. The kernels are attention_common.cuh's, over PagedPool: bf16 q
// with d in {64, 128} (every main path) runs the tensor-core design (a
// 3-stage cp.async ring of 64-slot tiles shared by the CTA's rows: wgmma
// on two warpgroups of 64 rows, so the 512 rows of a 128-token prompt read
// each tile 4 times and not 32, or mma.sync warps that split each tile's
// slots for 16 rows or fewer; split partials merged by decode_merge_kernel);
// fp32 q and d = 256 run the FMA design (fma_split_kernel, 32-slot tiles,
// then decode_merge_kernel). The TPU grid is (B, Hkv, MAXP) with the page axis
// run in order; here each stream's visible slot range is cut into tiles
// split evenly across `nsplit` CTAs, every CTA finding its range from
// q_pos on the device (no host readback per layer). Each row of a tile
// looks up its own page in the table (one lookup a tile when page % 64 ==
// 0), so any page size works and a tile may straddle pages. Rows of a
// tile outside the stream's visible slots are not read and load as zeros:
// junk written past a stream's offset (bucket padding, the shared trash
// page 0) never enters a product, and pages wholly past the last visible
// slot or below the window are never touched. Pool offsets are 64-bit: a
// pool of 16 streams x 16 pages of 512 slots at 8B widths holds more
// elements than an int reaches.

#include "attention_common.cuh"

namespace {

// Where one stream's K/V rows live: the pool row of logical slot j is
// (head + table[j / page] * Hkv) * page + j % page, counted in rows of d
// elements (and, for the scale pools, in elements), with head = layer * P
// * Hkv + h.
struct PagedPool {
  const int* table;  // (B, maxp)
  int P, Hkv, page, maxp, layer;

  struct Stream {
    const int* table;  // this stream's maxp page entries
    size_t head;
    int Hkv, page, shift;  // shift: log2(page) for a power of two, else -1

    __device__ __forceinline__ size_t at(int slot) const {
      const int lp = shift >= 0 ? slot >> shift : slot / page;
      const size_t phys = static_cast<size_t>(__ldg(table + lp));
      return (head + phys * Hkv) * page + (slot - lp * page);
    }
    // a tile's slots are consecutive rows when the tile lies in one page,
    // so one lookup serves the tile; else each row looks up its own page
    __device__ __forceinline__ bool contiguous() const { return page % tc::BK == 0; }
  };

  __device__ __forceinline__ int slots() const { return maxp * page; }
  __device__ __forceinline__ Stream stream(int b, int h) const {
    return Stream{table + static_cast<size_t>(b) * maxp,
                  static_cast<size_t>(layer) * P * Hkv + h, Hkv, page,
                  (page & (page - 1)) == 0 ? __ffs(page) - 1 : -1};
  }
};

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16. kv_int8: 0 = pools have q's dtype,
// 1 = int8 codes with fp32 (L, P, Hkv, page) scale pools. table: int32
// (B, maxp); q_pos: int32 (B, S). window <= 0: no window. design, slices,
// part_acc and part_ml as for run() in attention_common.cuh. Returns
// cudaGetLastError() after the launches.
extern "C" int k3_paged_decode_attention(
    const void* q, const void* pool_k, const void* pool_v, const void* k_scale,
    const void* v_scale, const void* table, const void* q_pos, void* out, void* part_acc,
    void* part_ml, int B, int Hkv, int S, int rows, int d, int P, int page, int maxp, int layer,
    int window, int nsplit, int q_dtype, int kv_int8, int design, int slices, void* stream) {
  const PagedPool pool{static_cast<const int*>(table), P, Hkv, page, maxp, layer};
  return run(design, q_dtype, kv_int8, d, slices, q, pool_k, pool_v, k_scale, v_scale, q_pos,
             out, part_acc, part_ml, B, pool, Args{Hkv, S, rows, window, nsplit},
             static_cast<cudaStream_t>(stream));
}
