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
// (flash_common.cuh); this entry reads q, k and v through batch, head and
// row strides, so the SigLIP tower passes permuted views of its packed
// (B, S, 3*H*D) projection and nothing is copied (the TPU path transposes to
// (B, H, S, D) first), and it writes the output through strides too (the
// wrapper gives a (B, S, H, D) buffer, so merging the heads is free).
//
// What bounds it on the H100: at the SigLIP-896 shape (16 heads of 72 over
// 4096 keys) the two products are 4*72 flops per score element against one
// exp, a max and a sum: the tensor cores at mma.sync rates and the
// unpipelined K/V tile loads, not HBM (each block streams all 4096 keys of
// its head). At the T5 shape (d=64, 640 keys) with the in-kernel bias the
// softmax work weighs as much as the products; the bias costs a shared-
// memory read per score element instead of the dense (H, S, S) stream.
//
// Specialisations: the head dim, and one instantiation with segment ids,
// the window/overlay band and the T5 bias compiled in (each checking its
// pointer once per tile) beside one without them (the SigLIP tower's plain
// bidirectional attention; the T5 decoder's causal one). The TPU kernel's
// batch grouping and single-KV-block shortcut are Mosaic scheduling devices
// and are not carried over.

#include "flash_common.cuh"

namespace {

using flash::Params;

template <int D, bool TERMS>
constexpr auto flash_attention_kernel = flash::attention_kernel<D, TERMS, TERMS, TERMS, true>;

template <int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  // the key mask, the bias and causal are runtime terms of every
  // instantiation (the main mask pass)
  const bool terms = p.seg != nullptr || p.bidir != nullptr || p.window > 0 ||
                     p.rel != nullptr;
  if (!terms)
    return flash::launch(flash_attention_kernel<D, false>, p, B,
                         flash::smem_bytes<D>(), stream);
  const int smem = flash::smem_bytes<D>() +
                   (p.rel != nullptr ? (p.Sk + flash::BQ) * 4 : 0);
  return flash::launch(flash_attention_kernel<D, true>, p, B, smem, stream);
}

}  // namespace

// Strides are in elements; pointers and the batch, head and row strides of
// q, k, v and o must keep 16-byte alignment (the wrapper checks). k and v
// have H heads. bias strides may be 0 (broadcast). kv_mask, seg and bidir
// are int32 (B, Sk) arrays or null (seg and bidir need Sq == Sk); rel is an
// fp32 (H, num_buckets) table and rel_bucket an int32 (Sq + Sk - 1) table,
// entry col - row + Sq - 1, or both null. Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for a head dim other than 64, 72, 80,
// 128 or 256).
extern "C" int flash_attention_forward(
    const void* q, const void* k, const void* v, void* o, const void* bias,
    const void* kv_mask, const void* seg, const void* bidir, const void* rel,
    const void* rel_bucket, int B, int H, int Sq, int Sk, int D,
    int num_buckets,
    long long q_bs, long long q_hs, long long q_rs,
    long long k_bs, long long k_hs, long long k_rs,
    long long v_bs, long long v_hs, long long v_rs,
    long long o_bs, long long o_hs, long long o_rs,
    long long bias_bs, long long bias_hs, long long bias_qs,
    long long bias_ks, int causal, int window, float scale, void* stream) {
  Params p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.bias = static_cast<const float*>(bias);
  p.kv_mask = static_cast<const int*>(kv_mask);
  p.seg = static_cast<const int*>(seg);
  p.bidir = static_cast<const int*>(bidir);
  p.rel = static_cast<const float*>(rel);
  p.rel_bucket = static_cast<const int*>(rel_bucket);
  p.H = H;
  p.kv_rep = 1;
  p.Sq = Sq;
  p.Sk = Sk;
  p.num_buckets = num_buckets;
  p.q_bs = q_bs; p.q_hs = q_hs; p.q_rs = q_rs;
  p.k_bs = k_bs; p.k_hs = k_hs; p.k_rs = k_rs;
  p.v_bs = v_bs; p.v_hs = v_hs; p.v_rs = v_rs;
  p.o_bs = o_bs; p.o_hs = o_hs; p.o_rs = o_rs;
  p.bias_bs = bias_bs; p.bias_hs = bias_hs; p.bias_qs = bias_qs;
  p.bias_ks = bias_ks;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return static_cast<int>(launch<64>(p, B, s));
    case 72: return static_cast<int>(launch<72>(p, B, s));
    case 80: return static_cast<int>(launch<80>(p, B, s));
    case 128: return static_cast<int>(launch<128>(p, B, s));
    case 256: return static_cast<int>(launch<256>(p, B, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
