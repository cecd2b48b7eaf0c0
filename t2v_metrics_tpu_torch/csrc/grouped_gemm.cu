// Grouped GEMM of the MoE expert dispatch for Hopper (sm_90a), bf16 in and
// out, fp32 accumulation.
//
// Replaces the TPU kernel t2v_metrics_tpu/ops/moe.py:_gmm_kernel (entered
// through grouped_matmul).
//
// Semantics (as the TPU kernel and grouped_matmul_reference):
//   out[r, :] = xg[r, :] @ w[block_expert[r / BM]]      for every row r < P
// xg (P, K) and out (P, N) are row-major; w (E, K, N) holds each expert's
// (K, N) matrix row-major, the JAX layout; block_expert (P / BM,) int32.
// Rows are grouped in blocks of BM = 128 (the dispatch's block_m), each block
// one expert's; the dispatch's pad rows are computed like any other and
// their outputs never read. Each output element is summed in fp32 and
// rounded to bf16 once.
//
// What bounds it on the H100: the tensor cores. At the Qwen3-VL-30B-A3B
// shapes of a 4 x 4 call at 1024x1024 (P = 147,456 rows: 16 x 1024 tokens x
// top-8 plus 128 x 128 rows of padding; gate_up K 2048, N 1536; down K 768,
// N 2048) the products are ~0.93 and ~0.46 TFLOP per layer against ~1.9 and
// ~1.2 GB of operands and output (counted from the shapes), some 380-500
// flops per byte when each crosses HBM once: above the ~295 flop/byte at
// which the tensor cores, not HBM, are the limit, provided each operand
// tile is read from HBM about once and reused from L2 and shared memory.
//
// What the design does about it: one block of 8 warps per 128 x 128 output
// tile, so a block's rows are one row block and one expert. A 4-stage ring
// of cp.async copies streams 128 x 32 tiles of xg and 32 x 128 tiles of the
// expert's weights through shared memory; rows are padded by 16 bytes so
// that the ldmatrix fragment loads are free of bank conflicts. Each warp
// computes a 64 x 32 sub-tile with mma.sync m16n8k16 (bf16 in, fp32
// accumulators in registers): A fragments by ldmatrix, B fragments by
// ldmatrix.trans from the (K, N) tile, as the flat attention kernel reads V.
// The grid is rastered in groups of 16 row blocks with the row block
// running fastest: consecutive blocks share an expert's weight column tile
// (the TPU kernel's row-innermost order, moe.py:127-134, which lets Pallas
// skip the refetch), and the group's 16 row blocks of xg (4 MB at K=2048)
// stay in L2 across the N/128 column tiles instead of being read from HBM
// once per column tile. wgmma, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // rows per tile = the dispatch's row block
constexpr int BN = 128;        // output columns per tile
constexpr int BK = 32;         // k per pipeline stage
constexpr int STAGES = 4;
constexpr int THREADS = 256;   // 8 warps: 2 (rows) x 4 (columns)
constexpr int GROUP = 16;      // row blocks per raster group
constexpr int LDA = BK + 8;    // padded row of the xg tile (80 bytes)
constexpr int LDB = BN + 8;    // padded row of the weight tile (272 bytes)
constexpr int A_STAGE = BM * LDA;
constexpr int B_STAGE = BK * LDB;
constexpr int SMEM = STAGES * (A_STAGE + B_STAGE) * 2;

struct Params {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;
  const int* be;
  __nv_bfloat16* o;
  int P, K, N, E;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// D(16x8, f32) += A(16x16, bf16, row) * B(16x8, bf16, col)
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(THREADS)
grouped_gemm_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + STAGES * A_STAGE;

  // raster: groups of GROUP row blocks, the row block fastest in a group
  const int n_rb = p.P / BM;
  const int per_group = GROUP * (p.N / BN);
  const int pid = blockIdx.x;
  const int group = pid / per_group;
  const int first = group * GROUP;
  const int gsize = min(n_rb - first, GROUP);
  const int local = pid - group * per_group;
  const int rb = first + local % gsize;
  const int nt = local / gsize;

  // an id outside [0, E) (never made by the dispatch plan) reads expert 0
  // rather than memory past the weights
  int e = p.be[rb];
  if (e < 0 || e >= p.E) e = 0;
  const __nv_bfloat16* xa = p.x + (long long)rb * BM * p.K;
  const __nv_bfloat16* wb = p.w + (long long)e * p.K * p.N + (long long)nt * BN;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 2) * 64;   // the warp's first row in the tile
  const int wn = (warp & 3) * 32;    // its first column

  // one stage: 512 16-byte chunks of xg (128 rows x 4) and 512 of the
  // weights (32 rows x 16), two of each per thread
  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BK;
    __nv_bfloat16* a = As + stage * A_STAGE;
    __nv_bfloat16* b = Bs + stage * B_STAGE;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      const int r = c >> 2, col = (c & 3) * 8;
      cp_async16(a + r * LDA + col, xa + (long long)r * p.K + k0 + col);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      const int r = c >> 4, col = (c & 15) * 8;
      cp_async16(b + r * LDB + col, wb + (long long)(k0 + r) * p.N + col);
    }
  };

  float acc[4][4][4];   // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int KT = p.K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();   // stage kt has landed
    __syncthreads();               // and every warp is done with kt - 1
    const int pf = kt + STAGES - 1;
    if (pf < KT) load_stage(pf % STAGES, pf);
    cp_async_commit();

    const __nv_bfloat16* a = As + (kt % STAGES) * A_STAGE;
    const __nv_bfloat16* b = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)   // rows 0-15 x k 0-7 / 8-15 per matrix pair
        ldmatrix_x4(af[i], a + (wm + i * 16 + (lane & 15)) * LDA + kk
                               + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < 2; ++j) {  // k 0-15 x two 8-column tiles
        uint32_t r[4];
        ldmatrix_x4_trans(r, b + (kk + (lane & 15)) * LDB + wn + j * 16
                                 + (lane >> 4) * 8);
        bf[2 * j][0] = r[0];
        bf[2 * j][1] = r[1];
        bf[2 * j + 1][0] = r[2];
        bf[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma16816(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }
  cp_async_wait<0>();

  // epilogue: each fragment row holds 2 adjacent columns, rounded once
  const int g = lane >> 2, t4 = lane & 3;
  __nv_bfloat16* ob = p.o + (long long)rb * BM * p.N + (long long)nt * BN;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = wm + i * 16 + g;
      const int col = wn + j * 8 + t4 * 2;
      *reinterpret_cast<uint32_t*>(ob + (long long)row * p.N + col) =
          pack_bf16(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<uint32_t*>(ob + (long long)(row + 8) * p.N + col) =
          pack_bf16(acc[i][j][2], acc[i][j][3]);
    }
  }
}

}  // namespace

// x (P, K), w (E, K, N), o (P, N) bf16 and be (P / 128,) int32, all
// contiguous and 16-byte aligned (the wrapper checks). P must be a multiple
// of 128, K of 32 and N of 128. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for shapes the kernel does not take).
extern "C" int grouped_gemm_forward(const void* x, const void* w,
                                    const void* be, void* o, int P, int K,
                                    int N, int E, void* stream) {
  if (P <= 0 || K <= 0 || N <= 0 || E <= 0 || P % BM || K % BK || N % BN)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.be = static_cast<const int*>(be);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.P = P;
  p.K = K;
  p.N = N;
  p.E = E;
  // above 48 KB a block gets dynamic shared memory only after this opt-in
  cudaError_t err = cudaFuncSetAttribute(
      grouped_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((P / BM) * (N / BN));
  grouped_gemm_kernel<<<blocks, THREADS, SMEM,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
