// W8A8 GEMM with the dequant epilogue fused, for Hopper (sm_90a).
//
// Replaces the TPU kernel t2v_metrics_tpu/ops/quant_matmul.py:_kernel
// (entered through quant_matmul; wrapper ops/quant.py:quant_matmul).
//
// Semantics (as the TPU kernel and quant_matmul_plain):
//   acc[m, n] = sum_k x_q[m, k] * w_q[k, n]          exact, int32, whole K
//   o[m, n]   = bf16_rn((float_rn(acc) * xs[m]) * ws[n])
// x_q (M, K) int8 row-major; the weight arrives transposed, w_qt (N, K) int8
// row-major (the leaf's storage; w_q = w_qt^T is the JAX (K, N) layout);
// xs (M,) and ws (N,) f32; o (M, N) bf16 row-major. The two products are
// __fmul_rn, never contracted into anything else, so the kernel matches its
// plain version bit for bit. The int32 accumulator lives in registers from
// the first k to the epilogue and never reaches device memory: that is the
// TPU kernel's reason to exist (quant_matmul.py:3-9), since an unfused
// epilogue writes and re-reads 4 bytes per output element.
//
// What bounds it on the H100: at the clip-flant5-xxl encoder shapes, the
// tensor cores. Encoder q|k|v at 32 pairs, (20480, 4096) x (4096, 12288), is
// 2.06 TOP against 0.64 GB of operands and output: ~3,200 operations a byte,
// far above the ~590 at which the int8 tensor cores (1,979 TOP/s), not HBM
// (3.35 TB/s), are the limit. The decoder's rows (M = pairs x 4) are bound
// by the weight bytes instead: (128, 10240) x (10240, 4096) reads 42 MB.
//
// What the design does about it (right and simple first): one block of 8
// warps per 128 x 128 output tile, a 4-stage ring of cp.async copies of
// 128 x 64-byte tiles of x_q and of w_qt through shared memory (rows padded
// by 16 bytes, so the ldmatrix loads are free of bank conflicts), each warp
// a 64 x 32 sub-tile by mma.sync m16n8k32 s8 x s8 -> s32. Both operands are
// K-contiguous, so plain (non-transposed) ldmatrix gives the A fragments and
// the "col" B fragments: sm_90 has no ldmatrix.trans for 8-bit elements,
// which is why the weight is stored (N, K). Ragged M and N edges: copies of
// rows past the edge are zero-filled (cp.async src-size 0) and their outputs
// not stored; a K tail past the last 64-byte step is zero-filled the same
// way. Tiles are rastered in groups of 8 row tiles, the row tile fastest, so
// a group's rows of x_q stay in L2 across the column tiles. wgmma, TMA and
// warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // output rows per tile
constexpr int BN = 128;        // output columns per tile
constexpr int BK = 64;         // k (bytes) per pipeline stage
constexpr int STAGES = 4;
constexpr int THREADS = 256;   // 8 warps: 2 (rows) x 4 (columns)
constexpr int GROUP = 8;       // row tiles per raster group
constexpr int LDS = BK + 16;   // padded smem row (80 bytes)
constexpr int A_STAGE = BM * LDS;
constexpr int B_STAGE = BN * LDS;
constexpr int SMEM = STAGES * (A_STAGE + B_STAGE);

struct Params {
  const int8_t* x;
  const int8_t* w;    // (N, K)
  const float* xs;
  const float* ws;
  __nv_bfloat16* o;
  int M, N, K;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy; src_bytes 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// four 8 x 16-byte matrices; lane l gets 4 bytes (l % 4) of row l / 4 of each
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// D(16x8, s32) += A(16x32, s8, row) * B(32x8, s8, col)
__device__ __forceinline__ void mma16832(int c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float dequant(int acc, float xs, float ws) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
}

__global__ void __launch_bounds__(THREADS)
quant_matmul_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* As = reinterpret_cast<int8_t*>(smem);
  int8_t* Bs = As + STAGES * A_STAGE;

  // raster: groups of GROUP row tiles, the row tile fastest in a group
  const int n_mt = (p.M + BM - 1) / BM;
  const int n_nt = (p.N + BN - 1) / BN;
  const int per_group = GROUP * n_nt;
  const int pid = blockIdx.x;
  const int first = (pid / per_group) * GROUP;
  const int gsize = min(n_mt - first, GROUP);
  const int local = pid % per_group;
  const int m0 = (first + local % gsize) * BM;
  const int n0 = (local / gsize) * BN;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 2) * 64;   // the warp's first row in the tile
  const int wn = (warp & 3) * 32;    // its first column

  // one stage: 512 16-byte chunks of x_q (128 rows x 4) and 512 of w_qt,
  // two of each per thread; rows past M or N and k past K read zeros
  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BK;
    int8_t* a = As + stage * A_STAGE;
    int8_t* b = Bs + stage * B_STAGE;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      const int r = c >> 2, col = (c & 3) * 16;
      const int k = k0 + col;
      const bool in_a = m0 + r < p.M && k < p.K;
      cp_async16(a + r * LDS + col,
                 in_a ? p.x + (long long)(m0 + r) * p.K + k : p.x, in_a ? 16 : 0);
      const bool in_b = n0 + r < p.N && k < p.K;
      cp_async16(b + r * LDS + col,
                 in_b ? p.w + (long long)(n0 + r) * p.K + k : p.w, in_b ? 16 : 0);
    }
  };

  int acc[4][4][4];   // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  const int KT = (p.K + BK - 1) / BK;
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

    const int8_t* a = As + (kt % STAGES) * A_STAGE;
    const int8_t* b = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4][4], bf[4][2];
      // A: matrices (rows 0-7, k 0-15), (8-15, 0-15), (0-7, 16-31),
      // (8-15, 16-31) of each 16-row tile: a0..a3 of m16n8k32
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(af[i], a + (wm + i * 16 + (lane & 15)) * LDS + kk
                               + (lane >> 4) * 16);
      // B: matrices (n 0-7, k 0-15), (0-7, 16-31), (8-15, 0-15),
      // (8-15, 16-31) of each 16-column pair: b0, b1 of two n8 tiles
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t r[4];
        ldmatrix_x4(r, b + (wn + j * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS
                           + kk + ((lane >> 3) & 1) * 16);
        bf[2 * j][0] = r[0];
        bf[2 * j][1] = r[1];
        bf[2 * j + 1][0] = r[2];
        bf[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma16832(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }
  cp_async_wait<0>();

  // epilogue: each fragment row holds 2 adjacent columns; N % 8 == 0, so a
  // pair is in or out whole
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn + j * 8 + t4 * 2;
    if (col >= p.N) continue;
    const float ws0 = p.ws[col], ws1 = p.ws[col + 1];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + i * 16 + g + h * 8;
        if (row >= p.M) continue;
        const float xs = p.xs[row];
        __nv_bfloat162 v = __floats2bfloat162_rn(
            dequant(acc[i][j][2 * h], xs, ws0), dequant(acc[i][j][2 * h + 1], xs, ws1));
        *reinterpret_cast<__nv_bfloat162*>(p.o + (long long)row * p.N + col) = v;
      }
    }
  }
}

}  // namespace

// x_q (M, K), w_qt (N, K) int8; xs (M,), ws (N,) f32; o (M, N) bf16; all
// contiguous and 16-byte aligned (the wrapper checks). K must be a multiple
// of 32 and N of 8. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for shapes the kernel does not take).
extern "C" int quant_matmul_forward(const void* x_q, const void* w_qt,
                                    const void* xs, const void* ws, void* o,
                                    int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 || N % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = static_cast<const int8_t*>(x_q);
  p.w = static_cast<const int8_t*>(w_qt);
  p.xs = static_cast<const float*>(xs);
  p.ws = static_cast<const float*>(ws);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.M = M;
  p.N = N;
  p.K = K;
  // above 48 KB a block gets dynamic shared memory only after this opt-in
  cudaError_t err = cudaFuncSetAttribute(
      quant_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  quant_matmul_kernel<<<static_cast<unsigned>(blocks), THREADS, SMEM,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
