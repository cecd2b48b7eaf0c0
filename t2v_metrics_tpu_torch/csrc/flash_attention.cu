// Per-head flash attention for Hopper (sm_90a), head dim 64, 72, 80, 128 or
// 256, bf16 in and out.
//
// Replaces the TPU kernel t2v_metrics_tpu/ops/attention.py:_flash_kernel
// (entered through flash_attention and attention()): attention over
// (B, H, S, D) with KV streamed in tiles under a running max and sum, the
// key mask, segment ids, end-aligned causal, a local window, the bidir
// overlay, an additive fp32 bias of (B or 1, H or 1, Sq, Sk), and the T5
// relative-position bias computed in the kernel from the (H, num_buckets)
// table (the TPU kernel's _rel_bias_block). The body is the flat kernel's
// (flash_common.cuh); here the wrapper's TMA tensor maps follow batch, head
// and row strides, so the SigLIP tower passes permuted views of its packed
// (B, S, 3*H*D) projection and nothing is copied (the TPU path transposes to
// (B, H, S, D) first), and the output is written through strides too (the
// wrapper gives a (B, S, H, D) buffer, so merging the heads is free).
//
// What bounds it on the H100: at the SigLIP-896 shape (16 heads of 72 over
// 4096 keys, no mask) the two products are 4*72 flops per score element
// against one exp, a max and a sum; the padded head dim (80) adds 11% to
// the products, and a warpgroup waits for its own products before its
// softmax, with the other warpgroup's turn filling that gap: ~4.4 ms on an
// H100 80GB HBM3 at 700 W, ~280 TFLOP/s, where the tensor cores' peak is
// ~1.25 ms. K and V stream from L2 (each of a head's 32 q-tile blocks reads
// all 4096 keys). At the T5 shape (d=64, 640 keys) with the in-kernel bias
// the softmax work weighs as much as the products; the bias costs a
// shared-memory read per score element instead of the dense (H, S, S)
// stream, and the REL-only instantiation runs at or below the dense bias's
// time.
//
// Specialisations: the head dim, the variant (two consumer warpgroups, or
// one for Sq <= 64), and three sets of terms: none (the SigLIP tower's plain
// bidirectional attention; the key mask, a dense bias and causal are
// run-time terms of every instantiation), the T5 bias alone (the in-kernel
// T5 attention, encoder and decoder: a lean instantiation, no segment or
// band code), and everything (segment ids, the window/overlay band and the
// T5 bias, each checking its pointer). At d = 256 everything with the T5 bias
// runs on the one-warpgroup variant whatever Sq (the wrapper's q box says
// so): beside a producer warpgroup the consumers' 232 registers spill, while
// a block of one warpgroup gives a thread 255. The TPU kernel's batch
// grouping and single-KV-block shortcut are Mosaic scheduling devices and
// are not carried over.

#include "flash_common.cuh"

namespace {

template <int D>
cudaError_t launch(const long long* geo, const flash::Params& p, cudaStream_t stream) {
  const bool rel = p.rel != nullptr;
  const int rel_smem = rel ? (p.Sk + 128) * 4 : 0;   // Sk + BQ - 1 floats
  if (p.seg != nullptr || p.bidir != nullptr || p.window > 0) {
    if constexpr (D > 128) {
      // the T5 bias beside the other terms: one consumer warpgroup only
      if (rel) return flash::launch_variant<D, 1, true, true, true>(geo, p, rel_smem, stream);
      return flash::launch<D, true, true, false>(geo, p, 0, stream);
    } else {
      return flash::launch<D, true, true, true>(geo, p, rel_smem, stream);
    }
  }
  if (rel) return flash::launch<D, false, false, true>(geo, p, rel_smem, stream);
  return flash::launch<D, false, false, false>(geo, p, 0, stream);
}

}  // namespace

// geo: the q, k and v tensor maps' geometry (flash_common.cuh); k and v have
// H heads. Strides are in elements; o through o_bs, o_rs and o_hs. bias
// strides may be 0 (broadcast); bias_vec2 says its columns may be read in
// 8-byte pairs. kv_mask, seg and bidir are int32 (B, Sk) arrays or null (seg
// and bidir need Sq == Sk); rel is an fp32 (H, num_buckets) table and
// rel_bucket an int32 (Sq + Sk - 1) table, entry col - row + Sq - 1, or both
// null. Returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// for a head dim other than 64, 72, 80, 128 or 256, or a geometry the kernel
// does not take).
extern "C" int flash_attention_forward(
    const long long* geo, void* o, const void* bias, const void* kv_mask, const void* seg,
    const void* bidir, const void* rel, const void* rel_bucket, int B, int H, int KVH,
    int Sq, int Sk, int D, int num_buckets, long long o_bs, long long o_rs, long long o_hs,
    long long bias_bs, long long bias_hs, long long bias_qs, long long bias_ks,
    int bias_vec2, int causal, int window, int head_major, float scale, void* stream) {
  if (KVH != H || (rel == nullptr) != (rel_bucket == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const flash::Params p = flash::make_params(
      o, bias, kv_mask, seg, bidir, rel, rel_bucket, B, H, KVH, Sq, Sk, num_buckets, o_bs,
      o_rs, o_hs, bias_bs, bias_hs, bias_qs, bias_ks, bias_vec2, causal, window, head_major,
      scale);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return static_cast<int>(launch<64>(geo, p, s));
    case 72: return static_cast<int>(launch<72>(geo, p, s));
    case 80: return static_cast<int>(launch<80>(geo, p, s));
    case 128: return static_cast<int>(launch<128>(geo, p, s));
    case 256: return static_cast<int>(launch<256>(geo, p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
