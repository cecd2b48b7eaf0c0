// The Hopper GEMM mainloop shared by the port's two GEMM kernels:
// grouped_gemm.cu (the MoE grouped GEMM, bf16 x bf16 -> fp32 accumulators)
// and quant_matmul.cu (the W8A8 GEMM, s8 x s8 -> exact s32 accumulators).
// Each source supplies an operation (`Op`: its tensor-map loads, its B
// descriptor, its four wgmma k-steps, its epilogue) and a kernel named for
// it that calls `run`; see the two sources for what each replaces.
//
// Design (the usual shape of a Hopper GEMM):
//   * One persistent block an SM (384 threads). Warpgroup 0 is the
//     producer: after setmaxnreg gives its registers away, its thread 0
//     walks the block's work units and keeps TMA copies of the A (128 rows)
//     and B (256 columns) tiles of each k-block in flight through a ring of
//     STAGES shared-memory stages, each completing on the stage's "full"
//     mbarrier; the other three warps are the operation's side work (the
//     grouped GEMM zeroes the rows past its used blocks there). Warpgroups 1
//     and 2 are the consumers, 64 output rows each of a 128 x 256 tile.
//   * A consumer issues a k-block's four wgmma with both operands in shared
//     memory (128-byte swizzle, as the TMA wrote them), commits them, and
//     waits until only this group is in flight (wgmma_wait<1>): the previous
//     k-block's stage is then read, and each consumer warp's lane 0 gives it
//     back on its "empty" mbarrier (a predicated arrive, no branch while a
//     product is in flight). The accumulators are zeroed before a unit's
//     first product, so every wgmma accumulates (a constant scale-d: a run-
//     time one makes ptxas serialize the products, PERF.md PR 6).
//   * Work units: output tiles in the L2-friendly raster of both kernels
//     (groups of `group` row tiles, the row tile fastest, so a group's A rows
//     stay in L2 across the column tiles and neighbouring row tiles share a
//     B tile), each cut into `splits` k-ranges (split K, for the int8
//     decoder shapes whose few tiles would leave most SMs idle). Unit u is
//     split u % splits of tile u / splits; block b takes units b, b + grid,
//     ... Producer and consumers walk the same list and count the k-blocks
//     they pass, so stage = i % STAGES and parity = (i / STAGES) & 1 of the
//     i-th k-block stay in step across units. One unit's epilogue runs while
//     the producer already loads the next unit's first stages.
//     ops/gemm.py `walk_unit` is the Python mirror the CPU tests hold.
//   * Epilogue: each consumer warp stages 16 rows x 64 columns of bf16 in
//     shared memory of its own (a padded pitch: conflict-free both ways) and
//     writes them back as 16-byte stores, a row's 128 bytes by 8 lanes.
//
// Shared memory: STAGES x (A 128 x 128 bytes + B 256 x 128 bytes) = 192 KB,
// the eight warps' epilogue buffers (18 KB), the mbarriers, and 1 KB of slack
// to align the base to the 128-byte swizzle's 1024-byte repeat. Registers:
// the producer keeps 40, each consumer thread gets 232, of which the
// accumulator takes 128 (64 x 256 over 128 threads).

#pragma once

#include <cuda_bf16.h>

#include "sm90.cuh"

namespace gemm {

constexpr int BM = 128;                 // output rows a tile: two consumers of 64
constexpr int BN = 256;                 // output columns a tile
constexpr int BK_BYTES = 128;           // k a stage: one swizzle span (64 bf16, 128 s8)
constexpr int STAGES = 4;
constexpr int THREADS = 384;
constexpr int CONSUMER_WARPS = 8;
constexpr int A_BYTES = BM * BK_BYTES;                // 16 KB
constexpr int B_BYTES = BN * BK_BYTES;                // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int EPI_PITCH = 36;           // words a staged row: 32 bf16 pairs + 4 of pad
constexpr int EPI_WARP_BYTES = 16 * EPI_PITCH * 4;
constexpr int EPI_OFF = STAGES * STAGE_BYTES;
constexpr int BAR_OFF = EPI_OFF + CONSUMER_WARPS * EPI_WARP_BYTES;
constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 1024;
static_assert(SMEM <= 232448, "more shared memory than a block can have");

// One work unit: output tile (mt, nt) over k-blocks [kb0, kb1), split `split`.
struct Unit {
  int mt, nt, kb0, kb1, split;
};

struct Walk {
  int n_mt, n_nt, group, splits, kb;   // kb: the k-blocks of the whole K

  __device__ __forceinline__ int units() const { return n_mt * n_nt * splits; }

  __device__ __forceinline__ Unit unit(int u) const {
    const int t = u / splits;
    const int per_group = group * n_nt;
    const int first = (t / per_group) * group;
    const int gsize = min(n_mt - first, group);
    const int local = t - (t / per_group) * per_group;
    Unit w;
    w.mt = first + local % gsize;
    w.nt = local / gsize;
    w.split = u - t * splits;
    w.kb0 = w.split * kb / splits;
    w.kb1 = (w.split + 1) * kb / splits;
    return w;
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulator fragment of wgmma m64n256 (fp32 or s32): thread (warp w,
// lane = 4g + t4) holds, for j = 0..31, d[4j], d[4j+1] at row 16w + g,
// columns 8j + 2t4 and + 1, and d[4j+2], d[4j+3] at row 16w + g + 8.
//
// Stage one warp's 16 rows x 64 columns q (j = 8q .. 8q + 7) of bf16 pairs,
// pack(j, r) the pair of row g + 8r at column pair j, then store them: rows
// `row0 + 0..15` of the output from column `col0`, with the rows below
// `rows` and columns below `cols` written (cols a multiple of 8).
template <int Q, class Pack>
__device__ __forceinline__ void store_chunk(uint32_t* buf, int lane, Pack pack,
                                            __nv_bfloat16* o, long long ld, long long row0,
                                            long long rows, int col0, int cols) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    buf[g * EPI_PITCH + 4 * jj + t4] = pack(8 * Q + jj, 0);
    buf[(g + 8) * EPI_PITCH + 4 * jj + t4] = pack(8 * Q + jj, 1);
  }
  __syncwarp();
  const int ch = lane & 7;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (lane >> 3) + 4 * i;
    const uint4 v = *reinterpret_cast<const uint4*>(buf + r * EPI_PITCH + 4 * ch);
    const int col = col0 + 8 * ch;
    if (row0 + r < rows && col < cols)
      *reinterpret_cast<uint4*>(o + (row0 + r) * ld + col) = v;
  }
  __syncwarp();
}

// The whole kernel body; `op` as the notes above say.
template <class Op>
__device__ __forceinline__ void run(const Op& op, const Walk& walk) {
  using Acc = typename Op::Acc;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);                 // the producer's expect_tx
      sm90::mbar_init(&empty[s], CONSUMER_WARPS);   // lane 0 of each consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  const int units = walk.units();

  if (tid < 128) {
    // ---------------- producer warpgroup ----------------
    sm90::setmaxnreg_dec<40>();
    if (tid == 0) {
      op.prefetch_maps();
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = walk.unit(u);
        for (int kb = w.kb0; kb < w.kb1; ++kb, ++it) {
          const int stage = it % STAGES;
          if (it >= STAGES) sm90::mbar_wait(&empty[stage], ((it / STAGES) - 1) & 1);
          unsigned char* a = smem + stage * STAGE_BYTES;
          sm90::mbar_expect_tx(&full[stage], STAGE_BYTES);
          op.load(a, a + A_BYTES, &full[stage], w, kb);
        }
      }
    } else if (tid >= 32) {
      op.side_work(tid - 32, 96);
    }
  } else {
    // ---------------- consumer warpgroups: rows 64c .. 64c + 63 ----------------
    sm90::setmaxnreg_inc<232>();
    const int c = tid / 128 - 1;
    const int warp = (tid / 32) % 4, lane = tid % 32;
    uint32_t* buf = reinterpret_cast<uint32_t*>(smem + EPI_OFF + (4 * c + warp) * EPI_WARP_BYTES);
    const uint32_t base = sm90::smem_u32(smem);
    Acc acc[128];
    int it = 0;
    // issue the four k-steps of the stage
    auto issue = [&](int stage) {
      const uint32_t a = base + stage * STAGE_BYTES;
      const uint64_t da = sm90::make_desc(a + c * 64 * BK_BYTES, 16, 1024, sm90::SWIZZLE_128B);
      const uint64_t db = Op::b_desc(a + A_BYTES);
      sm90::mbar_wait(&full[stage], (it / STAGES) & 1);
      sm90::reg_fence(acc);
      sm90::wgmma_fence();
      Op::mma(acc, da, db);
      sm90::wgmma_commit();
      sm90::reg_fence(acc);
    };
    auto release = [&](int stage) { sm90::mbar_arrive_if(&empty[stage], lane == 0); };
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit w = walk.unit(u);
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0;
      int prev = it % STAGES;
      issue(prev);
      ++it;
      for (int kb = w.kb0 + 1; kb < w.kb1; ++kb, ++it) {
        const int stage = it % STAGES;
        issue(stage);
        sm90::wgmma_wait<1>();   // the previous k-block's products are done
        sm90::reg_fence(acc);
        release(prev);
        prev = stage;
      }
      sm90::wgmma_wait<0>();
      sm90::reg_fence(acc);
      release(prev);
      op.epilogue(acc, w, 64 * c + 16 * warp, lane, buf);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side. geo holds, for each map, GEO int64 as ops/gemm.py TensorMap
// packs them: the base address, the rank (2 or 3), three extents (innermost
// first; 1 past the rank), two byte strides of dims 1 and 2, three box sizes,
// the swizzle in bytes and the element size in bytes.

constexpr int GEO = 12;

// Encode one map; its rank, box, swizzle and element size must be the ones
// the kernel loads (`box`).
inline cudaError_t encode(CUtensorMap* map, const long long* g, int rank, const int (&box)[3],
                          int elem) {
  const sm90::EncodeTiled fn = sm90::encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  if (g[1] != rank || g[10] != 128 || g[11] != elem) return cudaErrorInvalidValue;
  for (int i = 0; i < 3; ++i)
    if (g[7 + i] != (i < rank ? box[i] : 1)) return cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {(cuuint64_t)g[2], (cuuint64_t)g[3], (cuuint64_t)g[4]};
  const cuuint64_t strides[2] = {(cuuint64_t)g[5], (cuuint64_t)g[6]};
  const cuuint32_t boxes[3] = {(cuuint32_t)box[0], (cuuint32_t)box[1], (cuuint32_t)box[2]};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = fn(map, elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                          rank, reinterpret_cast<void*>(g[0]), dims, strides, boxes, unit,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace gemm
