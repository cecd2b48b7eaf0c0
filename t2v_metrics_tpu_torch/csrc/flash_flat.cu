// Flat flash attention for Hopper (sm_90a), head dim 64, 72, 80, 128 or
// 256, bf16 in and out.
//
// Replaces the TPU kernel t2v_metrics_tpu/ops/attention.py:_flash_flat_kernel
// (entered through flash_attention_flat / flash_attention_flat_packed).
//
// Layout. q, k and v are read in place from the flat (B, S, cols) projection
// layout: each comes as a base pointer with a batch stride, a row stride and
// a column offset, so the packed (B, S, (H+2KvH)*D) qkv projection and three
// separate arrays are one kernel, and nothing is sliced into a copy. Head h
// reads q columns off_q + h*D and k/v columns off_kv + (h / kv_rep)*D (GQA).
// The output is (B, Sq, H*D) bf16 with head h at column h*D. Terms: an fp32
// (1, H, Sq, Sk) bias, the key mask, end-aligned causal, segment ids, a
// local window and the bidir overlay (Gemma 3 image blocks); their
// semantics and the body of the kernel are in flash_common.cuh.
//
// What bounds it on the H100: at the clip-flant5 shapes (d=64, S<=640) the
// two products are 2*64 flops per score element each, while the fp32 softmax
// does a max, a subtract, an exp and a sum per element and the T5 bias adds a
// 4-byte read per element. So the kernel is bound by the softmax work and the
// bias stream, not by the tensor cores, and the (Sq, Sk) score matrix must
// never reach HBM. At the Qwen2.5-VL shapes (d=80 ViT over up to 5120 keys,
// d=128 decoder prefill) and the Gemma 3 decoder prefill (d=256) the products
// weigh more per score element, and the unpipelined K/V tile loads and
// mma.sync (not wgmma) bound it instead.
//
// Specialisations: the head dim, segment ids (SEG: one extra int per key of
// each tile, in a pass after the other masks; in the per-element mask loop
// they cost the d=64 T5 site ~13%) and the window/overlay band (BAND), so
// the T5 and Qwen instantiations keep their instruction streams. With
// causal masking the block stops at the last key tile its rows can see, and
// with a window it starts at the first; no tile is skipped for segment ids
// (the Qwen ViT's windowed layers over a whole 5120-row bucket compute every
// tile and mask all but their window). The TPU kernel's head-group planning
// and its ones-column denominator on v are MXU and VMEM devices and are not
// carried over.

#include "flash_common.cuh"

namespace {

using flash::Params;

template <int D, bool SEG, bool BAND>
constexpr auto flash_flat_kernel = flash::attention_kernel<D, SEG, BAND, false, false>;

template <int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int smem = flash::smem_bytes<D>();
  const bool seg = p.seg != nullptr;
  const bool band = p.window > 0 || p.bidir != nullptr;
  if (seg && band) return flash::launch(flash_flat_kernel<D, true, true>, p, B, smem, stream);
  if (seg) return flash::launch(flash_flat_kernel<D, true, false>, p, B, smem, stream);
  if (band) return flash::launch(flash_flat_kernel<D, false, true>, p, B, smem, stream);
  return flash::launch(flash_flat_kernel<D, false, false>, p, B, smem, stream);
}

}  // namespace

// Strides and offsets are in elements. Pointers and every offset and stride
// of q, k, v and o must keep 16-byte alignment (the wrapper checks). seg and
// bidir are int32 (B, Sk) arrays or null, and need Sq == Sk; window > 0 is a
// local window (with causal). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a head dim other than 64, 72, 80, 128 or 256).
extern "C" int flash_flat_forward(
    const void* q, const void* k, const void* v, void* o, const void* bias,
    const void* kv_mask, const void* seg, const void* bidir, int B, int H,
    int KVH, int Sq, int Sk, int D,
    long long q_bs, long long q_rs, long long q_off,
    long long k_bs, long long k_rs, long long k_off,
    long long v_bs, long long v_rs, long long v_off,
    long long o_bs, long long o_rs,
    long long bias_hs, long long bias_qs, long long bias_ks,
    int causal, int window, float scale, void* stream) {
  Params p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.bias = static_cast<const float*>(bias);
  p.kv_mask = static_cast<const int*>(kv_mask);
  p.seg = static_cast<const int*>(seg);
  p.bidir = static_cast<const int*>(bidir);
  p.H = H;
  p.kv_rep = H / KVH;
  p.Sq = Sq;
  p.Sk = Sk;
  p.q_bs = q_bs; p.q_rs = q_rs; p.q_off = q_off;   // head strides: D, fixed
  p.k_bs = k_bs; p.k_rs = k_rs; p.k_off = k_off;   // by the kernel
  p.v_bs = v_bs; p.v_rs = v_rs; p.v_off = v_off;
  p.o_bs = o_bs; p.o_rs = o_rs;
  p.bias_hs = bias_hs; p.bias_qs = bias_qs; p.bias_ks = bias_ks;
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
