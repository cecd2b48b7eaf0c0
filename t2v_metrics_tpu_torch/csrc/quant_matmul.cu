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
// plain version bit for bit. Without split K the int32 accumulator lives in
// registers from the first k to the epilogue and never reaches device
// memory: that is the TPU kernel's reason to exist (quant_matmul.py:3-9).
//
// What bounds it on the H100: at the clip-flant5-xxl encoder shapes, the
// tensor cores. Encoder q|k|v at 32 pairs, (20480, 4096) x (4096, 12288), is
// 2.06 TOP against 0.64 GB of operands and output: ~3,200 operations a byte,
// far above the ~590 at which the int8 tensor cores (1,979 TOP/s), not HBM
// (3.35 TB/s), are the limit. The decoder's rows (M = pairs x 4) are bound
// by the weight bytes instead: (128, 10240) x (10240, 4096) reads 42 MB.
//
// What the design does about it: the shared Hopper mainloop of
// gemm_sm90.cuh (a producer warp keeping TMA loads in flight through a
// 4-stage mbarrier ring, two consumer warpgroups running wgmma
// m64n256k32.s32.s8.s8 on 128 x 256 tiles of 128-byte k-blocks, one
// persistent block an SM). Both operands are K-major, as 8-bit wgmma needs
// (it has no transpose): that is why the weight is stored (N, K). Ragged M
// and N edges and the K tail are the TMA's zero fill, with masked stores.
// Tiles are rastered in groups of 8 row tiles, the row tile fastest, so a
// group's rows of x_q stay in L2 across the column tiles. Split K, for the
// decoder shapes whose 16-48 tiles would leave most of the 132 SMs idle (the
// wrapper picks the splits, ops/gemm.py split_k): each unit writes its exact
// int32 partial sums to a workspace (S, M, N), and a second kernel sums the
// S partials (integer sums are exact in any order, so the result stays
// bitwise that of one whole-K sum) and applies the same epilogue.
//
// Tensor parallelism splits K across ranks the same way (a row-parallel
// product, ops/quant.py:int8_matmul): each rank's launch writes only its
// int32 partials (o null), the ranks all-reduce them (exact), and
// quant_matmul_dequant runs the second kernel on the sum, so the sharded
// product is bitwise the unsharded one, as GSPMD's int32 reduce makes it.

#include "gemm_sm90.cuh"

namespace {

constexpr int GROUP = 8;        // row tiles a raster group

struct Params {
  const float* xs;
  const float* ws;
  __nv_bfloat16* o;
  int* part;                    // (splits, M, N) int32 partial sums, or null
  int M, N, K, splits;
};

__device__ __forceinline__ float dequant(int acc, float xs, float ws) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
}

struct Int8 {
  using Acc = int;
  const CUtensorMap* ta;
  const CUtensorMap* tb;
  Params p;

  __device__ void prefetch_maps() const {
    sm90::tma_prefetch(ta);
    sm90::tma_prefetch(tb);
  }

  __device__ void load(unsigned char* a, unsigned char* b, uint64_t* bar, const gemm::Unit& w,
                       int kb) const {
    sm90::tma_load_2d(a, ta, bar, kb * gemm::BK_BYTES, w.mt * gemm::BM);
    sm90::tma_load_2d(b, tb, bar, kb * gemm::BK_BYTES, w.nt * gemm::BN);
  }

  // B K-major, as A: rows of 128 bytes, 8-row groups 1024 bytes apart
  static __device__ uint64_t b_desc(uint32_t b) {
    return sm90::make_desc(b, 16, 1024, sm90::SWIZZLE_128B);
  }

  // four k32 steps, 32 bytes apart inside the 128-byte span
  static __device__ void mma(int (&acc)[128], uint64_t da, uint64_t db) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::wgmma_s8_m64n256k32(acc, da + 2 * kk, db + 2 * kk);
  }

  __device__ void side_work(int, int) const {}

  __device__ void epilogue(int (&acc)[128], const gemm::Unit& w, int row, int lane,
                           uint32_t* buf) const {
    const int g = lane >> 2, t4 = lane & 3;
    const long long row0 = (long long)w.mt * gemm::BM + row;
    const int col0 = w.nt * gemm::BN;
    if (p.part != nullptr) {
      // split K: the exact partial sums, a column pair a thread (32
      // contiguous bytes a row for the 4 threads of a row group)
      int* part = p.part + (long long)w.split * p.M * p.N;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = col0 + 8 * j + 2 * t4;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const long long m = row0 + g + 8 * r;
          if (m < p.M && col < p.N)
            *reinterpret_cast<int2*>(part + m * p.N + col) =
                make_int2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
        }
      }
      return;
    }
    const float xs0 = p.xs[min(row0 + g, (long long)p.M - 1)];
    const float xs1 = p.xs[min(row0 + g + 8, (long long)p.M - 1)];
    auto pack = [&](int j, int r) {
      const int col = col0 + 8 * j + 2 * t4;
      const float2 ws = col < p.N ? __ldg(reinterpret_cast<const float2*>(p.ws + col))
                                  : make_float2(0.f, 0.f);
      const float xs = r ? xs1 : xs0;
      return gemm::pack_bf16(dequant(acc[4 * j + 2 * r], xs, ws.x),
                             dequant(acc[4 * j + 2 * r + 1], xs, ws.y));
    };
    gemm::store_chunk<0>(buf, lane, pack, p.o, p.N, row0, p.M, col0, p.N);
    gemm::store_chunk<1>(buf, lane, pack, p.o, p.N, row0, p.M, col0 + 64, p.N);
    gemm::store_chunk<2>(buf, lane, pack, p.o, p.N, row0, p.M, col0 + 128, p.N);
    gemm::store_chunk<3>(buf, lane, pack, p.o, p.N, row0, p.M, col0 + 192, p.N);
  }
};

__global__ void __launch_bounds__(gemm::THREADS, 1)
quant_matmul_kernel(const __grid_constant__ CUtensorMap ta,
                    const __grid_constant__ CUtensorMap tb, const Params p) {
  const Int8 op{&ta, &tb, p};
  const gemm::Walk walk{(p.M + gemm::BM - 1) / gemm::BM, (p.N + gemm::BN - 1) / gemm::BN, GROUP,
                        p.splits, (p.K + gemm::BK_BYTES - 1) / gemm::BK_BYTES};
  gemm::run(op, walk);
}

// Split K's second pass: 8 outputs a thread, the S partials summed in int32
// (exact) and dequantized as the fused epilogue does.
__global__ void __launch_bounds__(256)
quant_matmul_kernel_reduce(const Params p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long mn = (long long)p.M * p.N;
  if (i * 8 >= mn) return;
  const long long e = i * 8;
  const long long m = e / p.N;
  const int n = static_cast<int>(e - m * p.N);
  int s[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int k = 0; k < p.splits; ++k) {
    const int4* src = reinterpret_cast<const int4*>(p.part + k * mn + e);
    const int4 a = src[0], b = src[1];
    s[0] += a.x; s[1] += a.y; s[2] += a.z; s[3] += a.w;
    s[4] += b.x; s[5] += b.y; s[6] += b.z; s[7] += b.w;
  }
  const float xs = p.xs[m];
  const float4 w0 = *reinterpret_cast<const float4*>(p.ws + n);
  const float4 w1 = *reinterpret_cast<const float4*>(p.ws + n + 4);
  uint4 v;
  v.x = gemm::pack_bf16(dequant(s[0], xs, w0.x), dequant(s[1], xs, w0.y));
  v.y = gemm::pack_bf16(dequant(s[2], xs, w0.z), dequant(s[3], xs, w0.w));
  v.z = gemm::pack_bf16(dequant(s[4], xs, w1.x), dequant(s[5], xs, w1.y));
  v.w = gemm::pack_bf16(dequant(s[6], xs, w1.z), dequant(s[7], xs, w1.w));
  *reinterpret_cast<uint4*>(p.o + e) = v;
}

}  // namespace

// geo: the tensor maps of x_q (M, K) and w_qt (N, K), gemm::GEO int64 each
// (ops/gemm.py); xs (M,), ws (N,) f32; o (M, N) bf16; part: with splits > 1
// an int32 workspace of splits x M x N, else null; all contiguous and
// 16-byte aligned (the wrapper checks). With o null the launch writes only
// the int32 partials into part (any splits; xs and ws unread). K must be a
// multiple of 32 and N of 8, splits at most K / 128 rounded up; grid: the
// persistent blocks (at most one an SM). Returns cudaGetLastError() after
// the launches (cudaErrorInvalidValue for shapes or maps the kernel does not
// take).
extern "C" int quant_matmul_forward(const long long* geo, const void* xs, const void* ws,
                                    void* o, void* part, int M, int N, int K, int splits,
                                    int grid, void* stream) {
  const int kb = (K + gemm::BK_BYTES - 1) / gemm::BK_BYTES;
  const bool partials_only = o == nullptr;
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 || N % 8 || grid <= 0 || splits < 1 || splits > kb ||
      (partials_only ? part == nullptr : (splits > 1) != (part != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ta, tb;
  cudaError_t err = gemm::encode(&ta, geo, 2, {gemm::BK_BYTES, gemm::BM, 1}, 1);
  if (err == cudaSuccess)
    err = gemm::encode(&tb, geo + gemm::GEO, 2, {gemm::BK_BYTES, gemm::BN, 1}, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.xs = static_cast<const float*>(xs);
  p.ws = static_cast<const float*>(ws);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.part = static_cast<int*>(part);
  p.M = M;
  p.N = N;
  p.K = K;
  p.splits = splits;
  // above 48 KB a block gets dynamic shared memory only after this opt-in
  err = cudaFuncSetAttribute(quant_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             gemm::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  quant_matmul_kernel<<<grid, gemm::THREADS, gemm::SMEM, st>>>(ta, tb, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1 || partials_only) return static_cast<int>(err);
  const long long blocks = ((long long)M * N / 8 + 255) / 256;
  quant_matmul_kernel_reduce<<<static_cast<unsigned>(blocks), 256, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The second pass alone: part (splits, M, N) int32 partial sums (from
// quant_matmul_forward with o null, all-reduced across ranks), summed and
// dequantized into o (M, N) bf16 with xs (M,) and ws (N,) f32. N must be a
// multiple of 8; all contiguous and 16-byte aligned (the wrapper checks).
extern "C" int quant_matmul_dequant(const void* part, const void* xs, const void* ws, void* o,
                                    int M, int N, int splits, void* stream) {
  if (M <= 0 || N <= 0 || N % 8 || splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.xs = static_cast<const float*>(xs);
  p.ws = static_cast<const float*>(ws);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.part = static_cast<int*>(const_cast<void*>(part));
  p.M = M;
  p.N = N;
  p.K = 0;
  p.splits = splits;
  const long long blocks = ((long long)M * N / 8 + 255) / 256;
  quant_matmul_kernel_reduce<<<static_cast<unsigned>(blocks), 256, 0,
                               static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
