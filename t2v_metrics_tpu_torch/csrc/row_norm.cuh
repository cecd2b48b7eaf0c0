// Row norms for Hopper (sm_90a): the body that LayerNorm (csrc/layer_norm.cu)
// and RMSNorm (csrc/rms_norm.cu) instantiate, with one launch plan
// (ops/norms.py:layer_norm_plan) and, for each, an entry that folds the
// residual add in.
//
// Semantics, for each row of d values of type T (bf16, fp16 or fp32), in fp32:
//   LayerNorm: mean = sum(x) / d,  var = sum((x - mean)^2) / d   (not E[x^2] - mean^2)
//              y = (x - mean) * rsqrt(var + eps) * scale (+ bias), rounded once to T
//   RMSNorm:   y = x * rsqrt(sum(x^2) / d + eps), no mean subtracted; with
//              `offset` the weight is scale + offset rounded to T (Gemma's
//              1 + w); with `cast` y is rounded to T before the weight (HF
//              T5), and the product of two T values is then correctly rounded
//              to T; without it y * w is rounded once
// The add entries first form s = x + r in fp32 and round it once to T, as
// PyTorch's eager add does, write s, and normalize the rounded s: s is
// bitwise the eager sum, y the norm of it.
//
// What bounds them on the H100: bytes. A row norm does ~8 flops an element
// against 4 bytes of bf16 in and out (the add: 8 bytes), some 2 flops a
// byte, far under the ~295 at which the tensor cores, not HBM, would be the
// limit. So the kernel moves each element through HBM once each way, keeps
// the row in registers between its statistics, and avoids the latency
// chains (a block reduction with barriers, a second read) that leave a
// small norm far from its bound.
//
// What the design does about it:
// - A warp owns a row where the row fits in ~40 values a lane (d <= 1280:
//   the ViT widths 1024 and 1152, the talker's 1024); wider rows take 2-16
//   warps (4 at d = 4608, 8 at 3584), and only they combine the warps'
//   partial sums through shared memory. A one-warp row reduces with
//   __shfl_xor_sync alone, no barrier.
// - The row is nvec = d / V vectors of V elements, in strips of 32: warp w
//   of the row's warps takes the nv strips from w * nv, lane l vector l of
//   each (q = (w * nv + i) * 32 + l, i < nv, q < nvec), so neighbouring
//   lanes read neighbouring addresses and a lane's vectors sit at fixed
//   offsets from its first. V is the widest vector (16 bytes at most) that
//   lays the row evenly over the lanes (8 bf16 at d = 1024: 4 a lane; 4 bf16
//   at d = 1152: 9 a lane, no column padded), else the widest that divides
//   d, with the vectors past the row predicated off (a power-of-two block
//   would mask 12.5% of the lanes at d = 3584 and 22% at 3200).
// - A lane issues all of its row's loads before it uses the first; the
//   statistics then come from registers: one HBM round trip a row.
//   LayerNorm takes two sums (the mean, then the centred squares), RMSNorm
//   one.
// - The weights are loaded once per block, into shared memory (cp.async,
//   waited for only before their first use, so the copy overlaps the first
//   rows' loads), and each lane reads its slice from there for every row
//   the block owns: they cost no registers (held in registers, the compiler
//   kept them in fp32, which alone took a 1024-wide bf16 row to 128
//   registers a thread and spilled).
// - Blocks of 8 warps (16 above d = 10240), at most one wave of resident
//   blocks (SMs x blocks an SM, from the occupancy of the instantiation),
//   with a row loop inside. The host computes the plan (ops/norms.py
//   layer_norm_plan) and checks its index arithmetic on the CPU.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace row_norm {

constexpr int MAX_BLOCK_WARPS = 16;
constexpr int STATIC_SMEM_LIMIT = 48 * 1024;   // above it, dynamic shared memory needs an opt-in

// The two norms, as the kernel's first template argument (so a profiler's
// kernel name says which one ran).
struct LayerNorm {
  static constexpr bool RMS = false;
};
struct RmsNorm {
  static constexpr bool RMS = true;
};

struct Params {
  const void* x;
  const void* r;                  // the add entry only
  const void* scale;
  const void* bias;               // LayerNorm, or null
  void* s;                        // the add entry only: x + r, (rows, d) dense
  void* y;                        // (rows, d) dense
  long long x_stride, r_stride;   // elements between rows
  int rows, nvec;                 // nvec = d / V vectors a row
  int nv;                         // strips of 32 vectors a warp
  int warps_per_row;
  float d, eps;
  float offset;                   // RMSNorm: added to the weight, or 0
  int cast;                       // RMSNorm: round y to T before the weight
};

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }

// Copy `bytes` (4, 8 or 16) from global to shared memory without a register
// round trip; cp_async_wait makes the calling thread's copies visible.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem), "n"(BYTES)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The sum of v over the row's lanes: a butterfly in the warp; with more than
// one warp a row, the warps' partials through shared memory, added in warp
// order so that every warp of the row gets the same value. wpr is the same
// for the whole block, so the barrier is reached by all of its threads.
__device__ __forceinline__ float row_sum(float v, float* part, int wpr, int warp, int lane) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (wpr == 1) return v;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  const int first = warp - warp % wpr;
  v = 0.f;
  for (int w = 0; w < wpr; ++w) v += part[first + w];
  return v;
}

// Launch bounds with a minimum of one block: without it ptxas held most
// instantiations to 64 (or 40) registers and spilled to get there.
template <typename N, typename T, int V, int NV, bool ADD>
__global__ void __launch_bounds__(MAX_BLOCK_WARPS * 32, 1) row_norm_kernel(const Params p) {
  using P = Pack<T, V>;
  // scale, then bias (when given): nvec vectors each
  extern __shared__ __align__(16) unsigned char smem[];
  P* const sw = reinterpret_cast<P*>(smem);
  P* const sb = sw + p.nvec;
  // Two buffers of the warps' partial sums. A warp writes its partial for a
  // sum only after the barrier of the sum before it, which every warp of the
  // block passes only once it has read the sum before that: so no sum may
  // reuse the buffer of the sum just before it. LayerNorm takes two sums a
  // row, the first in buffer 0 and the second in 1; RMSNorm one, in buffer
  // 0 and 1 by turns from row to row (`turn`).
  __shared__ float part[2][MAX_BLOCK_WARPS];
  // the weights' copy runs while the first rows load; it is waited for
  // just before their first use
  const bool has_bias = p.bias != nullptr;
  for (int q = threadIdx.x; q < p.nvec; q += blockDim.x) {
    if constexpr (sizeof(P) >= 4) {
      cp_async<sizeof(P)>(sw + q, static_cast<const P*>(p.scale) + q);
      if (has_bias) cp_async<sizeof(P)>(sb + q, static_cast<const P*>(p.bias) + q);
    } else {
      sw[q] = static_cast<const P*>(p.scale)[q];
      if (has_bias) sb[q] = static_cast<const P*>(p.bias)[q];
    }
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wpr = p.warps_per_row;
  const int q0 = (warp % wpr) * p.nv * 32 + lane;   // the lane's first vector
  const int rows_per_block = static_cast<int>(blockDim.x >> 5) / wpr;
  // slot i holds vector q0 + 32 i of the row, while i < held: the warp's
  // strips and the row both reach it
  const int held = min(p.nv, (p.nvec - q0 + 31) / 32);

  bool first = true;
  int turn = 0;   // RMSNorm: the buffer of this row's sum
  for (long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block; row0 < p.rows;
       row0 += static_cast<long long>(gridDim.x) * rows_per_block) {
    const long long row = row0 + warp / wpr;
    const bool live = row < p.rows;
    P v[NV] = {};
    const P* xr = reinterpret_cast<const P*>(static_cast<const T*>(p.x) + row * p.x_stride) + q0;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (live && i < held) v[i] = xr[32 * i];
    if constexpr (ADD) {
      P rv[NV] = {};
      const P* rr =
          reinterpret_cast<const P*>(static_cast<const T*>(p.r) + row * p.r_stride) + q0;
#pragma unroll
      for (int i = 0; i < NV; ++i)
        if (live && i < held) rv[i] = rr[32 * i];
      P* sr = reinterpret_cast<P*>(static_cast<T*>(p.s)) + row * p.nvec + q0;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
#pragma unroll
        for (int k = 0; k < V; ++k) v[i].v[k] = from_f32<T>(to_f32(v[i].v[k]) + to_f32(rv[i].v[k]));
        if (live && i < held) sr[32 * i] = v[i];
      }
    }

    // the slots past the row are zero in both sums
    float mean = 0.f, rstd;
    if constexpr (N::RMS) {
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float c = to_f32(v[i].v[k]);
          sq += c * c;
        }
      rstd = rsqrtf(row_sum(sq, part[turn], wpr, warp, lane) / p.d + p.eps);
      turn ^= 1;
    } else {
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int k = 0; k < V; ++k) sum += to_f32(v[i].v[k]);
      mean = row_sum(sum, part[0], wpr, warp, lane) / p.d;

      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if (i < held) {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float c = to_f32(v[i].v[k]) - mean;
            sq += c * c;
          }
        }
      }
      rstd = rsqrtf(row_sum(sq, part[1], wpr, warp, lane) / p.d + p.eps);
    }

    if (first) {   // the same iteration for every thread of the block
      cp_async_wait();
      __syncthreads();
      first = false;
    }
    P* yr = reinterpret_cast<P*>(static_cast<T*>(p.y)) + row * p.nvec + q0;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (live && i < held) {
        const P w = sw[q0 + 32 * i];
        P o;
        if constexpr (N::RMS) {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            float wk = to_f32(w.v[k]);
            if (p.offset != 0.f) wk = to_f32(from_f32<T>(wk + p.offset));
            float yk = to_f32(v[i].v[k]) * rstd;
            if (p.cast) yk = to_f32(from_f32<T>(yk));
            o.v[k] = from_f32<T>(wk * yk);
          }
        } else {
          const P b = has_bias ? sb[q0 + 32 * i] : P{};
#pragma unroll
          for (int k = 0; k < V; ++k)
            o.v[k] = from_f32<T>((to_f32(v[i].v[k]) - mean) * rstd * to_f32(w.v[k]) +
                                 to_f32(b.v[k]));
        }
        yr[32 * i] = o;
      }
    }
  }
}

using Kernel = void (*)(Params);

// The instantiations of one norm: vectors of V elements, NV of them a lane at
// most (NV * V <= 40). ops/norms.py LN_NV lists the same values; the plan
// picks the least NV that holds the lane's share of the row.
template <typename N>
struct Instances {
  template <typename T, int V, bool ADD, int... NVS>
  static Kernel pick_nv(int nv) {
    Kernel k = nullptr;
    ((k = nv == NVS ? &row_norm_kernel<N, T, V, NVS, ADD> : k), ...);
    return k;
  }

  template <typename T, bool ADD>
  static Kernel pick(int vec, int nv) {
    switch (vec) {
      case 8:
        if constexpr (sizeof(T) == 2) return pick_nv<T, 8, ADD, 1, 2, 4, 5>(nv);
        return nullptr;
      case 4:
        return pick_nv<T, 4, ADD, 1, 2, 4, 5, 9, 10>(nv);
      case 2:
        return pick_nv<T, 2, ADD, 1, 5, 10, 20>(nv);
      case 1:
        return pick_nv<T, 1, ADD, 1, 10, 20, 40>(nv);
      default:
        return nullptr;
    }
  }

  static Kernel kernel_for(int dtype, int vec, int nv, bool add) {
    switch (dtype) {
      case 0:
        return add ? pick<__nv_bfloat16, true>(vec, nv) : pick<__nv_bfloat16, false>(vec, nv);
      case 1:
        return add ? pick<__half, true>(vec, nv) : pick<__half, false>(vec, nv);
      case 2:
        return add ? pick<float, true>(vec, nv) : pick<float, false>(vec, nv);
      default:
        return nullptr;
    }
  }
};

constexpr int ITEM_BYTES[] = {2, 2, 4};   // by dtype: 0 bf16, 1 fp16, 2 fp32

// The kernel for these arguments with the dynamic shared memory for its
// weights allowed, or null.
template <typename N>
Kernel prepared(int dtype, int vec, int nv, bool add, int d, bool has_bias, int* smem) {
  if (dtype < 0 || dtype > 2) return nullptr;
  const Kernel k = Instances<N>::kernel_for(dtype, vec, nv, add);
  if (k == nullptr || d <= 0) return nullptr;
  *smem = d * ITEM_BYTES[dtype] * (has_bias ? 2 : 1);
  if (*smem > STATIC_SMEM_LIMIT &&
      cudaFuncSetAttribute(reinterpret_cast<const void*>(k),
                           cudaFuncAttributeMaxDynamicSharedMemorySize, *smem) != cudaSuccess)
    return nullptr;
  return k;
}

// Check the plan against the kernel and launch it. Returns the launch's CUDA
// error (cudaErrorInvalidValue for arguments the kernels do not take).
template <typename N>
int launch(Params p, int d, int dtype, int vec, int nv_cap, int block_warps, int grid,
           void* stream) {
  int smem = 0;
  const Kernel k = prepared<N>(dtype, vec, nv_cap, p.r != nullptr, d, p.bias != nullptr, &smem);
  if (k == nullptr || p.rows <= 0 || d % vec || p.nv <= 0 || p.nv > nv_cap ||
      p.warps_per_row <= 0 || block_warps > MAX_BLOCK_WARPS || block_warps % p.warps_per_row ||
      grid <= 0 || static_cast<long long>(p.warps_per_row) * p.nv * 32 * vec < d ||
      (p.r == nullptr) != (p.s == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  p.nvec = d / vec;
  p.d = static_cast<float>(d);
  void* args[] = {&p};
  cudaError_t err = cudaLaunchKernel(reinterpret_cast<const void*>(k), dim3(grid),
                                     dim3(block_warps * 32), args, smem,
                                     static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

// The arguments one norm does not take: LayerNorm's offset and cast,
// RMSNorm's bias.
template <typename N>
bool foreign(bool has_bias, float offset, int cast) {
  return N::RMS ? has_bias : (offset != 0.f || cast != 0);
}

// The C entry of both libraries, row_norm_forward: y = norm(x), or with r
// (and s) given, s = x + r and y = norm(s).
template <typename N>
int forward(const void* x, const void* r, const void* scale, const void* bias, void* s, void* y,
            long long x_stride, long long r_stride, int rows, int d, int dtype, int vec,
            int nv_cap, int nv, int warps_per_row, int block_warps, int grid, float eps,
            float offset, int cast, void* stream) {
  if (foreign<N>(bias != nullptr, offset, cast)) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.x = x;
  p.r = r;
  p.scale = scale;
  p.bias = bias;
  p.s = s;
  p.y = y;
  p.x_stride = x_stride;
  p.r_stride = r_stride;
  p.rows = rows;
  p.nv = nv;
  p.warps_per_row = warps_per_row;
  p.eps = eps;
  p.offset = offset;
  p.cast = cast;
  return launch<N>(p, d, dtype, vec, nv_cap, block_warps, grid, stream);
}

// The other C entry, row_norm_blocks_per_sm: resident blocks an SM of one
// instantiation at block_warps warps a block, with its weights' shared
// memory, into *blocks. The host sizes the grid to one wave with it.
template <typename N>
int blocks_per_sm(int dtype, int vec, int nv_cap, int add, int d, int has_bias, int block_warps,
                  int* blocks) {
  int smem = 0;
  const Kernel k = prepared<N>(dtype, vec, nv_cap, add != 0, d, has_bias != 0, &smem);
  if (k == nullptr || foreign<N>(has_bias != 0, 0.f, 0) || block_warps <= 0 ||
      block_warps > MAX_BLOCK_WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, reinterpret_cast<const void*>(k), block_warps * 32, smem));
}

}  // namespace row_norm
