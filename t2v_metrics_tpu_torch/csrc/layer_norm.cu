// LayerNorm, and LayerNorm of a residual sum, for Hopper (sm_90a).
//
// Replaces the TPU kernel t2v_metrics_tpu/ops/norms.py:_ln_kernel (entered
// through layer_norm_fused; wrappers ops/norms.py:layer_norm_fused and
// add_layer_norm_fused).
//
// The kernel is the LayerNorm instantiation of the row-norm body in
// csrc/row_norm.cuh, which says what bounds it on the H100 and what the
// design does about it; RMSNorm (csrc/rms_norm.cu) is the other one, with
// the same two C entries.

#include "row_norm.cuh"

// y = LayerNorm(x) (+ bias, or null), or with r (and s) given, s = x + r and
// y = LayerNorm(s). offset and cast are RMSNorm's and must be 0. Pointers
// and row strides must be aligned to the vector (the wrapper checks); s and
// y are dense. nv_cap picks the instantiation, nv (<= nv_cap) is the strips
// of 32 vectors a warp takes. Returns the launch's CUDA error.
extern "C" int row_norm_forward(const void* x, const void* r, const void* scale, const void* bias,
                                void* s, void* y, long long x_stride, long long r_stride, int rows,
                                int d, int dtype, int vec, int nv_cap, int nv, int warps_per_row,
                                int block_warps, int grid, float eps, float offset, int cast,
                                void* stream) {
  return row_norm::forward<row_norm::LayerNorm>(x, r, scale, bias, s, y, x_stride, r_stride, rows,
                                                d, dtype, vec, nv_cap, nv, warps_per_row,
                                                block_warps, grid, eps, offset, cast, stream);
}

// Resident blocks an SM of one instantiation at block_warps warps a block,
// with its weights' shared memory, into *blocks: the host sizes the grid to
// one wave with it.
extern "C" int row_norm_blocks_per_sm(int dtype, int vec, int nv_cap, int add, int d,
                                      int has_bias, int block_warps, int* blocks) {
  return row_norm::blocks_per_sm<row_norm::LayerNorm>(dtype, vec, nv_cap, add, d, has_bias,
                                                      block_warps, blocks);
}
