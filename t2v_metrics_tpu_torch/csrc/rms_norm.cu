// RMSNorm, and RMSNorm of a residual sum, for Hopper (sm_90a).
//
// Replaces the TPU kernel t2v_metrics_tpu/ops/norms.py:_rms_kernel (entered
// through rms_norm_fused; wrappers ops/norms.py:rms_norm_fused and
// add_rms_norm_fused). Its qk-norm mode, which normalized the q|k heads of
// a packed row, is folded into the rotary embedding (ops/rope.py).
//
// The kernel is the RMSNorm instantiation of the row-norm body in
// csrc/row_norm.cuh, with LayerNorm's launch plan: what bounds it on the
// H100 and what the design does about it are said there. The add entry is
// what every RMSNorm that follows a residual add runs (the T5 blocks, the
// decoders, the Qwen2.5 ViT, InternViT-6B, Code2Wav's transformer): one
// pass reads x and r and writes s and y, where an eager add and a norm take
// two launches and five element passes.

#include "row_norm.cuh"

// y = RMSNorm(x), or with r (and s) given, s = x + r and y = RMSNorm(s).
// offset: added to the weight in its dtype (0: none); cast: round the
// normalized value to the element type before the weight; bias must be
// null (LayerNorm's). Pointers and row strides must be aligned to the vector
// (the wrapper checks); s and y are dense. nv_cap picks the instantiation,
// nv (<= nv_cap) is the strips of 32 vectors a warp takes. Returns the
// launch's CUDA error.
extern "C" int row_norm_forward(const void* x, const void* r, const void* scale, const void* bias,
                                void* s, void* y, long long x_stride, long long r_stride, int rows,
                                int d, int dtype, int vec, int nv_cap, int nv, int warps_per_row,
                                int block_warps, int grid, float eps, float offset, int cast,
                                void* stream) {
  return row_norm::forward<row_norm::RmsNorm>(x, r, scale, bias, s, y, x_stride, r_stride, rows,
                                              d, dtype, vec, nv_cap, nv, warps_per_row,
                                              block_warps, grid, eps, offset, cast, stream);
}

// Resident blocks an SM of one instantiation at block_warps warps a block,
// with its weight's shared memory (has_bias must be 0), into *blocks.
extern "C" int row_norm_blocks_per_sm(int dtype, int vec, int nv_cap, int add, int d,
                                      int has_bias, int block_warps, int* blocks) {
  return row_norm::blocks_per_sm<row_norm::RmsNorm>(dtype, vec, nv_cap, add, d, has_bias,
                                                    block_warps, blocks);
}
