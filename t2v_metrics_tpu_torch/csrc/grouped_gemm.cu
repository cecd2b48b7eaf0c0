// Grouped GEMM of the MoE expert dispatch for Hopper (sm_90a), bf16 in and
// out, fp32 accumulation.
//
// Replaces the TPU kernel t2v_metrics_tpu/ops/moe.py:_gmm_kernel (entered
// through grouped_matmul).
//
// Semantics (as the TPU kernel and grouped_matmul_reference):
//   out[r, :] = xg[r, :] @ w[block_expert[r / 128]]      for every row r < P
// xg (P, K) and out (P, N) are row-major; w (E, K, N) holds each expert's
// (K, N) matrix row-major, the JAX layout; block_expert (P / 128,) int32.
// Rows are grouped in blocks of 128 (the dispatch's block_m), each block one
// expert's. With num_blocks (a 1-element int32 device tensor: the leading
// row blocks that belong to an expert, from the dispatch plan's counts),
// only those blocks are computed and the rows past them are written as
// zeros: the dispatch appends E x 128 pad rows that no token reads (11% of
// the buffer at the Qwen3-VL-30B-A3B shape). Without it every block is
// computed, as the TPU kernel does. An id outside [0, E) (never made by the
// dispatch plan) reads expert 0 rather than memory past the weights. Each
// output element is summed in fp32 and rounded to bf16 once.
//
// What bounds it on the H100: the tensor cores. At the Qwen3-VL-30B-A3B
// shapes of a 4 x 4 call at 1024x1024 (131,072 routed rows: 16 x 1024
// tokens x top-8; gate_up K 2048, N 1536; down K 768, N 2048) the products
// are ~0.82 and ~0.41 TFLOP against ~1.7 and ~1.1 GB of operands and output
// (~470 and ~360 flop a byte), above the ~295 flop/byte at which the tensor
// cores, not HBM, are the limit, provided each operand tile is read from HBM
// about once.
//
// What the design does about it: the shared Hopper mainloop of
// gemm_sm90.cuh (a producer warp keeping TMA loads in flight through a
// 4-stage mbarrier ring, two consumer warpgroups running wgmma on 128 x 256
// tiles, one persistent block an SM). The A tile is a 2-D TMA box of xg;
// the B tile is four 3-D boxes (64 columns x 64 k x 1 expert) of w at the
// row block's expert, read in its (K, N) layout as the MN-major wgmma
// operand (the transpose-B immediate), so the 58 GB of expert weights are
// never transposed. Tiles are walked in groups of 16 row blocks with the row
// block fastest: consecutive tiles share an expert's weight column tile (the
// TPU kernel's row-innermost order, moe.py:127-134), and the group's 16 row
// blocks of xg stay in L2 across the column tiles. The three idle producer
// warps zero the rows past num_blocks meanwhile. Ragged K (K % 64) and N
// (N % 256) are the TMA's zero fill, the columns past N not stored.

#include "gemm_sm90.cuh"

namespace {

constexpr int GROUP = 16;       // row blocks a raster group
constexpr int KB_ELEMS = gemm::BK_BYTES / 2;   // 64 bf16 of k a stage
constexpr int B_PANEL = 64;     // columns a B box: one 128-byte swizzle span
constexpr int B_PANEL_BYTES = B_PANEL * KB_ELEMS * 2;

struct Params {
  const int* be;
  const int* num_blocks;        // null: every block
  __nv_bfloat16* o;
  int P, K, N, E;
};

struct Grouped {
  using Acc = float;
  const CUtensorMap* ta;
  const CUtensorMap* tb;
  Params p;
  int used;                     // row blocks computed

  __device__ void prefetch_maps() const {
    sm90::tma_prefetch(ta);
    sm90::tma_prefetch(tb);
  }

  __device__ void load(unsigned char* a, unsigned char* b, uint64_t* bar, const gemm::Unit& w,
                       int kb) const {
    sm90::tma_load_2d(a, ta, bar, kb * KB_ELEMS, w.mt * gemm::BM);
    int e = p.be[w.mt];
    if (e < 0 || e >= p.E) e = 0;
#pragma unroll
    for (int i = 0; i < gemm::BN / B_PANEL; ++i)
      sm90::tma_load_3d(b + i * B_PANEL_BYTES, tb, bar, w.nt * gemm::BN + i * B_PANEL,
                        kb * KB_ELEMS, e);
  }

  // B MN-major: each k row of a panel is 64 columns (one swizzle span), the
  // 8-row k groups 1024 bytes apart (SBO), the next panel of 64 columns a
  // panel away (LBO); a k16 step is 16 rows further.
  static __device__ uint64_t b_desc(uint32_t b) {
    return sm90::make_desc(b, B_PANEL_BYTES, 1024, sm90::SWIZZLE_128B);
  }

  static __device__ void mma(float (&acc)[128], uint64_t da, uint64_t db) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::Wgmma<256>::ss_mn(acc, da + 2 * kk, db + ((16 * 128 * kk) >> 4));
  }

  // the three idle producer warps: zeros in the rows past the used blocks
  __device__ void side_work(int t, int n) const {
    const long long first = (long long)used * gemm::BM * p.N;
    const long long vecs = ((long long)p.P * p.N - first) / 8;
    uint4* dst = reinterpret_cast<uint4*>(p.o + first);
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (long long i = (long long)blockIdx.x * n + t; i < vecs; i += (long long)gridDim.x * n)
      dst[i] = zero;
  }

  __device__ void epilogue(float (&acc)[128], const gemm::Unit& w, int row, int lane,
                           uint32_t* buf) const {
    const long long row0 = (long long)w.mt * gemm::BM + row;
    auto pack = [&](int j, int r) {
      return gemm::pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    };
    const int col0 = w.nt * gemm::BN;
    gemm::store_chunk<0>(buf, lane, pack, p.o, p.N, row0, p.P, col0, p.N);
    gemm::store_chunk<1>(buf, lane, pack, p.o, p.N, row0, p.P, col0 + 64, p.N);
    gemm::store_chunk<2>(buf, lane, pack, p.o, p.N, row0, p.P, col0 + 128, p.N);
    gemm::store_chunk<3>(buf, lane, pack, p.o, p.N, row0, p.P, col0 + 192, p.N);
  }
};

__global__ void __launch_bounds__(gemm::THREADS, 1)
grouped_gemm_kernel(const __grid_constant__ CUtensorMap ta,
                    const __grid_constant__ CUtensorMap tb, const Params p) {
  const int n_rb = p.P / gemm::BM;
  int used = n_rb;
  if (p.num_blocks != nullptr) used = min(max(*p.num_blocks, 0), n_rb);
  const Grouped op{&ta, &tb, p, used};
  const gemm::Walk walk{used, (p.N + gemm::BN - 1) / gemm::BN, GROUP, 1,
                        (p.K + KB_ELEMS - 1) / KB_ELEMS};
  gemm::run(op, walk);
}

}  // namespace

// geo: the tensor maps of xg (2-D) and w (3-D), gemm::GEO int64 each (ops/
// gemm.py); be (P / 128,) int32; num_blocks a 1-element int32 or null; o
// (P, N) bf16, contiguous and 16-byte aligned (the wrapper checks). P must
// be a multiple of 128, K of 32 and N of 128; grid: the persistent blocks
// (at most one an SM). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for shapes or maps the kernel does not take).
extern "C" int grouped_gemm_forward(const long long* geo, const void* be, const void* num_blocks,
                                    void* o, int P, int K, int N, int E, int grid,
                                    void* stream) {
  if (P <= 0 || K <= 0 || N <= 0 || E <= 0 || grid <= 0 || P % gemm::BM || K % 32 || N % 128)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ta, tb;
  cudaError_t err = gemm::encode(&ta, geo, 2, {KB_ELEMS, gemm::BM, 1}, 2);
  if (err == cudaSuccess) err = gemm::encode(&tb, geo + gemm::GEO, 3, {B_PANEL, KB_ELEMS, 1}, 2);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.be = static_cast<const int*>(be);
  p.num_blocks = static_cast<const int*>(num_blocks);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.P = P;
  p.K = K;
  p.N = N;
  p.E = E;
  // above 48 KB a block gets dynamic shared memory only after this opt-in
  err = cudaFuncSetAttribute(grouped_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             gemm::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  grouped_gemm_kernel<<<grid, gemm::THREADS, gemm::SMEM, static_cast<cudaStream_t>(stream)>>>(
      ta, tb, p);
  return static_cast<int>(cudaGetLastError());
}
