// Flat flash attention for Hopper (sm_90a), head dim 64, 72, 80, 88, 128
// or 256, bf16 in and out.
//
// Replaces the TPU kernel t2v_metrics_tpu/ops/attention.py:_flash_flat_kernel
// (entered through flash_attention_flat / flash_attention_flat_packed).
//
// Layout. q, k and v are read in place from the flat (B, S, cols) projection
// layout: the wrapper describes each as a TMA tensor map over (head dim,
// heads, rows, batch) whose base address carries the column offset, so the
// packed (B, S, (H+2KvH)*D) qkv projection and three separate arrays are one
// kernel, and nothing is sliced into a copy. Head h reads q columns off_q +
// h*D and k/v columns off_kv + (h / kv_rep)*D (GQA). The output is (B, Sq,
// H*D) bf16 with head h at column h*D. Terms: an fp32 (1, H, Sq, Sk) bias,
// the key mask, end-aligned causal, segment ids, a local window and the bidir
// overlay (Gemma 3 image blocks); their semantics and the body of the kernel
// (wgmma fed by TMA through an mbarrier ring from a producer warp) are in
// flash_common.cuh.
//
// What bounds it on the H100: at the clip-flant5 shapes (d=64, S<=640) the
// two products are 2*64 flops per score element each, while the fp32 softmax
// does a max, an exp and a sum per element and the T5 bias adds a 4-byte
// read per element: the softmax's issue and MUFU rate and the bias stream
// (52 MB per call, read by every batch item's blocks from L2, which the
// head-major grid keeps it in) bound it, not the tensor cores; at the T5
// encoder site it runs ~0.8 ms on an H100 80GB HBM3 at 700 W, ~130 TFLOP/s.
// At the Qwen ViT shapes (d=80/72 over up to 5120 keys), the EVA ViT-g of
// BLIP-2 (d=88 over 257 keys, padded to 96 columns) and the decoder
// prefills (d=128, d=256) the products weigh more per score element; a
// warpgroup still waits for its own products before its softmax (the other
// warpgroup's turn fills that gap), so neither the tensor cores nor the
// softmax run at their peak. At the T5 decoder shapes (sq = 4) the
// one-warpgroup variant streams K/V with several blocks an SM: HBM and the
// blocks' start-up latency bound it.
//
// Specialisations: the head dim, the variant (two consumer warpgroups, or
// one for Sq <= 64), segment ids (SEG) and the window/overlay band (BAND),
// so the T5 and Qwen instantiations keep their instruction streams lean. With
// segment ids a block skips the key tiles none of its rows can see (the Qwen
// ViTs' pad tiles, the Qwen2.5 ViT's windowed layers over a whole 5120-row
// bucket: all but the tiles of its own windows) and runs the per-element
// compare only on a tile whose ids are mixed (flash_common.cuh, "Segment ids
// per key tile"). The TPU kernel's head-group planning and its ones-column
// denominator on v are MXU and VMEM devices and are not carried over.

#include "flash_common.cuh"

namespace {

template <int D>
cudaError_t launch(const long long* geo, const flash::Params& p, cudaStream_t stream) {
  const bool seg = p.seg != nullptr;
  const bool band = p.window > 0 || p.bidir != nullptr;
  if (seg && band) return flash::launch<D, true, true, false>(geo, p, 0, stream);
  if (seg) return flash::launch<D, true, false, false>(geo, p, 0, stream);
  if (band) return flash::launch<D, false, true, false>(geo, p, 0, stream);
  return flash::launch<D, false, false, false>(geo, p, 0, stream);
}

}  // namespace

// geo: the q, k and v tensor maps' geometry (flash_common.cuh). Strides are
// in elements; o is (B, Sq, H*D) through o_bs and o_rs (o_hs = D). bias is
// fp32 (1, H, Sq, Sk) through its strides (bias_bs 0) or null; bias_vec2 says
// its columns may be read in 8-byte pairs. seg and bidir are int32 (B, Sk)
// arrays or null, and need Sq == Sk; window > 0 is a local window (with
// causal); rel and rel_bucket must be null. Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for a head dim other than 64, 72, 80,
// 88, 128 or 256, or a geometry the kernel does not take).
extern "C" int flash_flat_forward(
    const long long* geo, void* o, const void* bias, const void* kv_mask, const void* seg,
    const void* bidir, const void* rel, const void* rel_bucket, int B, int H, int KVH,
    int Sq, int Sk, int D, int num_buckets, long long o_bs, long long o_rs, long long o_hs,
    long long bias_bs, long long bias_hs, long long bias_qs, long long bias_ks,
    int bias_vec2, int causal, int window, int head_major, float scale, void* stream) {
  if (rel != nullptr || rel_bucket != nullptr || H % KVH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const flash::Params p = flash::make_params(
      o, bias, kv_mask, seg, bidir, nullptr, nullptr, B, H, KVH, Sq, Sk, num_buckets, o_bs,
      o_rs, o_hs, bias_bs, bias_hs, bias_qs, bias_ks, bias_vec2, causal, window, head_major,
      scale);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return static_cast<int>(launch<64>(geo, p, s));
    case 72: return static_cast<int>(launch<72>(geo, p, s));
    case 80: return static_cast<int>(launch<80>(geo, p, s));
    case 88: return static_cast<int>(launch<88>(geo, p, s));
    case 128: return static_cast<int>(launch<128>(geo, p, s));
    case 256: return static_cast<int>(launch<256>(geo, p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
