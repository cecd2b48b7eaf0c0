// The flash attention body shared by the two attention kernels of the port:
// flash_flat.cu (the flat (B, S, H*D) layout) and flash_attention.cu (the
// per-head (B, H, S, D) layout), both instantiations of attention_kernel. The
// two layouts differ only in the TMA tensor maps the wrapper describes
// (ops/attention.py tma_geometry: base address, extents, byte strides, box),
// so one kernel reads both in place; see the two sources for what each
// replaces.
//
// Semantics (as the TPU kernels and the plain versions):
//   s = (q . k) * scale + bias[b, h, row, col] + rel[h, bucket(col - row)]
//   masked out: col >= Sk, kv_mask[b, col] == 0, seg[b, row] != seg[b, col]
//   (square attention only; -1 matches -1, as in the TPU kernel), and with
//   causal the keys after the end-aligned diagonal (col - (Sk - Sq) > row);
//   a local window W also drops col - (Sk - Sq) <= row - W; the bidir
//   overlay keeps (row, col) again when bidir[b, row] == bidir[b, col] >= 0,
//   over the causal/window band (it overrides the window, as in HF Gemma 3)
//   p = exp(s - running max) in fp32, rounded to bf16 before p . v
//   out = (sum p.v) / (sum p), and 0 for a row whose keys are all masked.
//
// Design (Hopper), the usual shape of a Hopper attention kernel:
//   * A block per (q tile, head, batch item) of three warpgroups (WG = 2,
//     q tiles of 128 rows). Warpgroup 0 is the producer: after setmaxnreg
//     gives its registers to the others, one thread loads the block's Q tile
//     and then keeps the K and V tiles of its key range in flight through a
//     ring of STAGES shared-memory stages, each a TMA copy
//     (cp.async.bulk.tensor) that completes on the stage's "full" mbarrier;
//     warp 1 writes each tile's key terms beside it (below). Warpgroups 1 and
//     2 are the consumers, 64 q rows each (wgmma's M).
//   * A consumer, per key tile, in one turn: S = Q K^T by wgmma with both
//     operands in shared memory (K-major), and O += P V of the previous tile
//     by wgmma with P as the register A operand (the accumulator's layout is
//     the A layout, so no shuffle) and V straight from its TMA tile as the
//     MN-major B operand (never transposed by hand). Once both are done, the
//     previous stage goes back to the producer (each warp arrives on its
//     "empty" mbarrier), and the masks and the online softmax of this tile
//     run on the fp32 accumulators in registers, then O *= alpha. The two
//     consumers take turns (two named barriers, as FlashAttention-3's
//     ping-pong), so one's softmax runs under the other's products. A
//     warpgroup does not overlap its own softmax with its own products: ptxas
//     serializes every wgmma of a kernel that writes a register of a product
//     in flight, and the softmax writes the score registers.
//   * Producer and consumers walk the same list of key tiles and count only
//     the tiles they visit, so a list with gaps (the band plus the overlay)
//     or none keeps the barrier phases in step (stage = i % STAGES, parity =
//     (i / STAGES) & 1 of the i-th visited tile). A block with no tile still
//     writes its zero rows; a consumer warpgroup whose 64 rows all lie past
//     Sq leaves at once (the empty barriers count only the warpgroups with
//     rows).
//   * Sq <= 64 (the T5 decoder's 4-row self- and cross-attention): one
//     warpgroup of 64 rows over 64-key tiles and no producer (WG = 1, 128
//     threads, several blocks an SM, so the blocks' start-up latencies
//     overlap); its thread 0 issues the TMA copies and the warpgroup refills
//     a stage once it has released it. The per-head kernel's T5 bias beside
//     the other terms at d = 256 takes this variant at any Sq, for its
//     registers (flash_attention.cu).
//
// Shared-memory layouts for wgmma. A tile (rows x padded head dim DP) is
// stored as panels of PW columns, each panel rows x (2 PW) bytes, one TMA box
// each, swizzled by the TMA as wgmma expects:
//   DP a multiple of 64 (d = 64, 128, 256): 64-column panels, 128-byte
//     swizzle; a Q.K^T k-step advances the start address 32 bytes inside a
//     panel, and 4 k-steps later moves to the next panel;
//   DP = 80 (d = 72, 80) and DP = 96 (d = 88, EVA ViT-g): 16-column panels,
//     32-byte swizzle (rows of 144, 160 or 192 bytes are not a multiple of
//     the 128-byte swizzle span); a k-step is one panel. At d = 72 and 88 the
//     last panel's box of 16 columns lies over an extent of 72 or 88, so the
//     TMA fills columns 72..79 or 88..95 with zeros (in a packed row they
//     would be the next head's lanes), and those columns add 0 to Q.K^T.
//   V as the MN-major B operand of P.V: the 8-key groups of a panel are
//     SBO = 8 x 2 PW bytes apart and the panels (the next PW output columns)
//     LBO = one panel apart; N = DP (80 at d = 72, 96 at d = 88: the zero
//     columns are computed and not stored).
// The ragged key edge (rows k0 + r >= Sk) is the TMA's zero fill too, and is
// masked as col >= Sk.
//
// Registers: 384 threads a block, one block an SM; the producer keeps 40
// registers and each consumer thread gets 232: at d = 256 the O accumulator
// is 128 of them (64 x 256 fp32 over 128 threads), the score tile 32 (BK =
// 64) and P 16, so Q stays in shared memory and is read by wgmma there.
// Every per-thread array is indexed by constants only: the row max and sum
// run as four independent chains, since a halving tree's run-time index put
// its array in local memory, and that alone cost half the kernel's time.
//
// Masks per key tile, not per element from global memory: the producer's
// warp 1 writes each tile's key terms into the stage beside K and V (an
// additive 0 or -inf for a key past Sk or masked by kv_mask, and each key's
// segment id and bidir id), and arrives on the stage's full barrier with the
// TMA. A consumer adds the key term to each score (read once per column pair
// it holds, shared by its two rows), and runs the per-element mask pass only
// for a tile whose segment ids it cannot settle as a whole (below), the band,
// or a tile that crosses the causal diagonal. The
// fp32 bias is read as 8-byte loads of the accumulator's column pairs where
// it has unit column stride: at d = 64 (the T5 sites) into registers while
// the tile's products run, and the next tile's prefetched into L1. The T5
// bucket bias is staged per block in shared memory: the bucket of each
// distance col - row is computed once per call by the wrapper
// (ops/position.py relative_position_bucket, the plain version's own
// function, so the buckets agree exactly; a CUDA logf one ulp off XLA's
// would flip buckets at their exact edges) into an int32 table of Sq + Sk -
// 1 entries, and each block stages its head's bias for the distances its
// rows can see (Sk + 127 floats).
//
// Key tiles: with causal the block stops at the last key tile its rows can
// see; with a window it starts at the first tile it can see. The bidir overlay can reopen tiles on either side: the block finds the
// range of keys whose id lies between the smallest and largest non-negative
// id of its rows (a superset of the keys it can reopen) and also visits those
// tiles.
//
// Segment ids per key tile. Before its key loop a block stages one byte of
// plan a key tile of its batch item, from the smallest and largest id of the
// tile's keys, of the block's rows and of each consumer warpgroup's 64 rows (a
// warp a tile; with Sq == Sk the rows are keys too): whether the block's rows'
// range meets the tile's, and for each warpgroup whether the tile is one id
// with its rows, mixed, or apart. A key tile the block's rows cannot meet is
// not visited: one more term of tile_visible, which the producer, its key-term
// warp and the consumers read alike from the one plan, so the barrier phases
// stay in step. Without the band compiled in (as at every segment-id site of
// the port), a consumer settles a visited tile as a whole where it can: if its
// 64 rows and the tile's keys all hold one id, the segment term keeps every
// score and the tile runs a copy of the score pass compiled without masks; if
// their ranges do not meet, every score is -inf without a compare; only a
// mixed tile takes the per-element compare (and only for a mixed tile does the
// key-term warp stage the keys' ids). The rule is conservative (ranges that
// meet with no id in common are mixed), so it adapts to whatever ids a call
// gives. The staging lies on the block's start, which nothing else overlaps
// (one block an SM), so the Q tile's copy is issued before it.
// ops/attention.py:segment_tile_plan counts the plan.
//
// The grid: a 1-D grid decoded as (q tile, head, batch) with the q tile
// fastest, so the q tiles of one (batch, head) run together and read its K/V
// while it is in L2, and the heads of a GQA group are neighbours; with a bias
// broadcast over the batch (the T5 self-attention's (1, H, S, S) fp32 bias,
// 52 MB at the encoder, more than the 50 MB L2) the order is (q tile, batch,
// head), so every block reading one head's bias runs together.
//
// Instantiations: head dim D, and terms compiled in by template flags so that
// a kernel without them keeps a lean instruction stream: SEG (segment ids),
// BAND (local window and the bidir overlay), REL (the in-kernel T5 bias). A
// compiled-in term also checks its pointer at run time. The key mask, the
// dense bias and causal are run-time terms of every instantiation.

#pragma once

#include <cuda_bf16.h>
#include <math.h>

#include "sm90.cuh"

namespace flash {

constexpr int NONE = 1 << 30;
constexpr int ID_MAX = 0x7fffffff, ID_MIN = -ID_MAX - 1;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int PINGPONG_BAR = 1;   // named barriers 1 and 2: the consumers' turns

// Bytes of the segment-id plan over Sk keys: a byte a key tile of BK, padded
// to 16.
template <int BK>
__host__ __device__ constexpr int seg_plan_bytes(int sk) {
  return ((sk + BK - 1) / BK + 15) / 16 * 16;
}

// Tiles of head dim D with WG consumer warpgroups (see the notes above):
// WG = 2 for a call with Sq > 64, WG = 1 for Sq <= 64.
template <int D, int WG>
struct Tile {
  static constexpr int DP = (D + 15) / 16 * 16;         // padded to the k16 step
  static constexpr bool SW128 = DP % 64 == 0;
  static constexpr int PW = SW128 ? 64 : 16;            // panel width, elements
  static constexpr int NP = DP / PW;                    // panels a tile
  static constexpr int ROWB = PW * 2;                   // bytes of a panel row
  static constexpr int SWIZZLE = SW128 ? sm90::SWIZZLE_128B : sm90::SWIZZLE_32B;
  static constexpr int BQ = 64 * WG;                    // q rows a block
  static constexpr int BK = WG == 1 || D > 128 ? 64 : 128;   // keys a tile
  static constexpr int STAGES = WG == 1 ? (D <= 128 ? 3 : 2) : (D <= 96 ? 3 : 2);
  static constexpr int THREADS = WG == 1 ? 128 : 384;
  static constexpr int MIN_BLOCKS = WG == 2 ? 1 : D <= 80 ? 3 : D <= 128 ? 2 : 1;
  static constexpr int Q_PANEL = BQ * ROWB, KV_PANEL = BK * ROWB;
  static constexpr int Q_BYTES = NP * Q_PANEL, KV_BYTES = NP * KV_PANEL;
  // dynamic shared memory: Q, K and V of each stage, 256 bytes of mbarriers
  // and ids, each stage's key terms (an additive float, the segment id and
  // the bidir id of each key), then, past REL_OFF, the segment-id runs' range
  // table (segment ids only) and the REL kernels' bias; 1 KB of slack to
  // align the base to the 128-byte swizzle's 1024-byte repeat
  static constexpr int BAR_OFF = Q_BYTES + STAGES * 2 * KV_BYTES;
  static constexpr int KEY_OFF = BAR_OFF + 256;
  static constexpr int KEY_BYTES = 3 * BK * 4;
  static constexpr int REL_OFF = KEY_OFF + STAGES * KEY_BYTES;
  static constexpr int SMEM = REL_OFF + 1024;
};

struct Params {
  __nv_bfloat16* o;
  const float* bias;        // fp32, read through the bias strides
  const int* kv_mask;       // (B, Sk) int32
  const int* seg;           // (B, Sk) int32, Sq == Sk
  const int* bidir;         // (B, Sk) int32, Sq == Sk
  const float* rel;         // (H, num_buckets) fp32
  const int* rel_bucket;    // (Sq + Sk - 1) int32: bucket of col - row + Sq - 1
  long long o_bs, o_rs, o_hs;
  long long bias_bs, bias_hs, bias_qs, bias_ks;
  int B, H, kv_rep, Sq, Sk, q_tiles, num_buckets;
  int bias_vec2;            // unit column stride, 8-byte aligned pairs
  int causal, window;       // window 0: none
  int head_major;           // grid order (q tile, batch, head)
  float scale;
  int axis[3][3];           // q, k, v: the map dim (1..3) of head, row, batch
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The TMA coordinate of map dim `dim` (1..3), whose axis is one of head,
// row and batch (`axis` of the operand).
__device__ __forceinline__ int coord(const int (&axis)[3], int dim, int h, int row, int b) {
  return axis[0] == dim ? h : axis[1] == dim ? row : b;
}

__device__ __forceinline__ void load_tile(void* dst, const CUtensorMap* map, uint64_t* bar,
                                          const int (&axis)[3], int panels, int panel_bytes,
                                          int pw, int h, int row, int b) {
  const int c1 = coord(axis, 1, h, row, b), c2 = coord(axis, 2, h, row, b),
            c3 = coord(axis, 3, h, row, b);
  for (int i = 0; i < panels; ++i)
    sm90::tma_load_4d(static_cast<unsigned char*>(dst) + i * panel_bytes, map, bar, i * pw,
                      c1, c2, c3);
}

// Reductions over the BK/4 scores of accumulator row r (0: row g, 1: row
// g + 8) that one thread holds: four independent chains, for instruction-
// level parallelism, with constant indices only (an array with a run-time
// index, as a halving tree's loop gives, lives in local memory).
template <int N>
__device__ __forceinline__ float row_max(const float (&s)[N], int r) {
  float a = s[2 * r], b = s[2 * r + 1], c = s[4 + 2 * r], d = s[4 + 2 * r + 1];
#pragma unroll
  for (int j = 2; j < N / 4; j += 2) {
    a = fmaxf(a, s[4 * j + 2 * r]);
    b = fmaxf(b, s[4 * j + 2 * r + 1]);
    c = fmaxf(c, s[4 * j + 4 + 2 * r]);
    d = fmaxf(d, s[4 * j + 4 + 2 * r + 1]);
  }
  return fmaxf(fmaxf(a, b), fmaxf(c, d));
}

template <int N>
__device__ __forceinline__ float row_sum(const float (&s)[N], int r) {
  float a = s[2 * r], b = s[2 * r + 1], c = s[4 + 2 * r], d = s[4 + 2 * r + 1];
#pragma unroll
  for (int j = 2; j < N / 4; j += 2) {
    a += s[4 * j + 2 * r];
    b += s[4 * j + 2 * r + 1];
    c += s[4 * j + 4 + 2 * r];
    d += s[4 * j + 4 + 2 * r + 1];
  }
  return (a + b) + (c + d);
}

template <int D, int WG, bool SEG, bool BAND, bool REL>
__global__ void __launch_bounds__(Tile<D, WG>::THREADS, Tile<D, WG>::MIN_BLOCKS)
attention_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const Params p) {
  using T = Tile<D, WG>;
  constexpr int BQ = T::BQ, BK = T::BK, STAGES = T::STAGES, DP = T::DP;
  constexpr bool EARLY_BIAS = DP == 64 && !BAND;   // the T5 sites
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + T::BAR_OFF);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;             // [STAGES]
  uint64_t* empty = bars + 1 + STAGES;   // [STAGES]
  int* ranges = reinterpret_cast<int*>(bars + 1 + 2 * STAGES);  // bidir: row / key min, max
  const bool seg_on = SEG && p.seg != nullptr;
  // segment ids: each key tile's plan (below)
  unsigned char* tile_plan = smem + T::REL_OFF;
  float* relb =
      reinterpret_cast<float*>(smem + T::REL_OFF + (seg_on ? seg_plan_bytes<BK>(p.Sk) : 0));

  const int id = blockIdx.x;
  const int qt = id % p.q_tiles;
  int h, b;
  if (p.head_major) {
    b = (id / p.q_tiles) % p.B;
    h = id / (p.q_tiles * p.B);
  } else {
    h = (id / p.q_tiles) % p.H;
    b = id / (p.q_tiles * p.H);
  }
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int n_wg = min(WG, (p.Sq - q0 + 63) / 64);    // consumer warpgroups with rows
  const int last_row = min(q0 + BQ, p.Sq) - 1;
  const int kvh = h / p.kv_rep;

  if (tid == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      // WG 2: the TMA thread and the 32 lanes staging the key terms
      sm90::mbar_init(&full[s], WG == 2 ? 33 : 1);
      sm90::mbar_init(&empty[s], 4 * n_wg);   // one arrival per consumer warp
    }
    sm90::fence_barrier_init();
    if constexpr (SEG) {
      if (seg_on) {   // the Q tile's copy runs under the segment-id staging below
        sm90::fence_proxy_async();
        sm90::mbar_expect_tx(q_full, T::Q_BYTES);
        load_tile(q_s, &tq, q_full, p.axis[0], T::NP, T::Q_PANEL, T::PW, h, q0, b);
      }
    }
  }
  // T5 bias of this head for the distances these rows see: relb[j] is the
  // bias of col - row = j + jmin - (Sq - 1)
  const bool rel_on = REL && p.rel != nullptr;
  const int jmin = p.Sq - 1 - last_row;
  if (rel_on) {
    const int count = p.Sk + last_row - q0;
    const float* col = p.rel + (long long)h * p.num_buckets;
    for (int i = tid; i < count; i += T::THREADS) relb[i] = col[p.rel_bucket[jmin + i]];
  }
  if constexpr (SEG) {
    if (seg_on) {
      // each key tile's plan, a warp a tile: bit 0, the block visits it (the id
      // ranges of its rows and the tile's keys meet); bits 1 + 2c and 2 + 2c,
      // warpgroup c's class: 0 one id (no compare), 1 mixed (the compare), 2
      // ranges apart (-inf). A warp loads its TILES tiles and the block's rows
      // (Sq == Sk: rows are keys) at once, so the plan costs the block's start
      // (which nothing overlaps, one block an SM) one round trip to L2 up to
      // TILES x BK x the warps keys; the consumers, whose registers are scarce
      // (ptxas gives the kernel 168), read a byte a tile and nothing else.
      constexpr int WARPS = T::THREADS / 32, TILES = 4;
      const int lane = tid % 32;
      const int* ids = p.seg + (long long)b * p.Sk;
      const int n_key_tiles = (p.Sk + BK - 1) / BK;
      for (int t0 = tid / 32; t0 < n_key_tiles; t0 += TILES * WARPS) {
        int rv[BQ / 32], kv[TILES][BK / 32];
#pragma unroll
        for (int i = 0; i < BQ / 32; ++i) {
          const int row = q0 + 32 * i + lane;
          rv[i] = row < p.Sq ? __ldg(ids + row) : 0;
        }
#pragma unroll
        for (int u = 0; u < TILES; ++u)
#pragma unroll
          for (int i = 0; i < BK / 32; ++i) {
            const int col = (t0 + u * WARPS) * BK + 32 * i + lane;
            kv[u][i] = col < p.Sk ? __ldg(ids + col) : 0;
          }
        // the id range of values [i0, i1) of v, value i at first + 32 i + lane
        auto range = [&](const int* v, int i0, int i1, int first, int end) {
          int lo = ID_MAX, hi = ID_MIN;
#pragma unroll
          for (int i = i0; i < i1; ++i)
            if (first + 32 * i + lane < end) {
              lo = min(lo, v[i]);
              hi = max(hi, v[i]);
            }
          return make_int2(__reduce_min_sync(0xffffffffu, lo),
                           __reduce_max_sync(0xffffffffu, hi));
        };
        auto meet = [](int2 x, int2 y) { return x.x <= y.y && x.y >= y.x; };
        const int2 rows = range(rv, 0, BQ / 32, q0, p.Sq);
        int2 wg[WG];   // warpgroup c: rows q0 + 64c .. + 63
#pragma unroll
        for (int c = 0; c < WG; ++c) wg[c] = range(rv, 2 * c, 2 * c + 2, q0, p.Sq);
#pragma unroll
        for (int u = 0; u < TILES; ++u) {
          const int kt = t0 + u * WARPS;
          const int2 keys = range(kv[u], 0, BK / 32, kt * BK, p.Sk);
          int plan = meet(keys, rows);
#pragma unroll
          for (int c = 0; c < WG; ++c) {
            const bool one = keys.x == keys.y && wg[c].x == wg[c].y && keys.x == wg[c].x;
            plan |= (!meet(keys, wg[c]) ? 2 : one ? 0 : 1) << (1 + 2 * c);
          }
          if (lane == 0 && kt < n_key_tiles) tile_plan[kt] = static_cast<unsigned char>(plan);
        }
      }
    }
  }
  // key tiles [ob_lo, ob_hi] the bidir overlay may reopen
  int ob_lo = NONE, ob_hi = -1;
  const int* bidb = BAND && p.bidir != nullptr ? p.bidir + (long long)b * p.Sk : nullptr;
  if (BAND && bidb != nullptr) {
    if (tid == 0) {
      ranges[0] = NONE; ranges[1] = -1; ranges[2] = NONE; ranges[3] = -1;
    }
    __syncthreads();
    if (tid < BQ && q0 + tid < p.Sq) {
      const int rid = bidb[q0 + tid];
      if (rid >= 0) {
        atomicMin(&ranges[0], rid);
        atomicMax(&ranges[1], rid);
      }
    }
    __syncthreads();
    const int lo = ranges[0], hi = ranges[1];
    if (hi >= 0) {
      for (int c = tid; c < p.Sk; c += T::THREADS) {
        const int kid = bidb[c];
        if (kid >= lo && kid <= hi) {
          atomicMin(&ranges[2], c);
          atomicMax(&ranges[3], c);
        }
      }
    }
    __syncthreads();
    if (ranges[3] >= 0) {
      ob_lo = ranges[2] / BK;
      ob_hi = ranges[3] / BK;
    }
  }
  __syncthreads();   // barriers initialised, relb and tile_plan staged

  // key tiles [kt_lo, n_tiles) of the causal / window band, and the overlay's
  const int shift = p.Sk - p.Sq;
  int n_tiles = (p.Sk + BK - 1) / BK;
  if (p.causal) {
    const int last_key = min(p.Sk - 1, last_row + shift);
    n_tiles = last_key < 0 ? 0 : last_key / BK + 1;
  }
  int kt_lo = 0;
  if (BAND && p.window > 0) kt_lo = max(0, q0 + shift - p.window + 1) / BK;
  const int kt_begin = BAND ? min(kt_lo, ob_lo) : 0;
  const int kt_end = BAND ? max(n_tiles, ob_hi + 1) : n_tiles;
  auto tile_visible = [&](int kt) {
    if constexpr (SEG) {
      if (seg_on && !(tile_plan[kt] & 1)) return false;   // no row shares an id with it
    }
    return !BAND || (kt >= kt_lo && kt < n_tiles) || (kt >= ob_lo && kt <= ob_hi);
  };

  const bool band_on = BAND && (p.window > 0 || bidb != nullptr);
  const long long key0 = (long long)b * p.Sk;   // batch item b's keys in the id arrays
  auto key_terms = [&](int stage) {
    return reinterpret_cast<float*>(smem + T::KEY_OFF + stage * T::KEY_BYTES);
  };
  // the key terms of tile kt into a stage, by `n` threads from index i: 0 or
  // -inf for each key (past Sk or masked), its segment id and bidir id
  auto stage_keys = [&](int stage, int kt, int i, int n) {
    float* kadd = key_terms(stage);
    int* kseg = reinterpret_cast<int*>(kadd + BK);
    int* kbid = kseg + BK;
    bool seg_ids = seg_on;   // the keys' ids, for a tile some warpgroup compares
    if constexpr (SEG && !BAND) {
      if (seg_on) {
        seg_ids = false;
#pragma unroll
        for (int c = 0; c < WG; ++c) seg_ids |= ((tile_plan[kt] >> (1 + 2 * c)) & 3) == 1;
      }
    }
    for (int c = i; c < BK; c += n) {
      const int col = kt * BK + c;
      const bool in = col < p.Sk;
      kadd[c] = in && (p.kv_mask == nullptr || p.kv_mask[key0 + col] != 0) ? 0.f : -INFINITY;
      if (seg_ids) kseg[c] = in ? p.seg[key0 + col] : 0;
      if (band_on && bidb != nullptr) kbid[c] = in ? p.bidir[key0 + col] : -1;
    }
  };
  // one thread: the K and V tiles of kt into a stage
  auto load_kv = [&](int stage, int kt) {
    unsigned char* k_s = smem + T::Q_BYTES + stage * 2 * T::KV_BYTES;
    sm90::mbar_expect_tx(&full[stage], 2 * T::KV_BYTES);
    load_tile(k_s, &tk, &full[stage], p.axis[1], T::NP, T::KV_PANEL, T::PW, kvh, kt * BK, b);
    load_tile(k_s + T::KV_BYTES, &tv, &full[stage], p.axis[2], T::NP, T::KV_PANEL, T::PW,
              kvh, kt * BK, b);
  };
  int kt_fill = kt_begin;   // WG 1: the next tile to load
  auto fill_next = [&](int stage) {
    while (kt_fill < kt_end && !tile_visible(kt_fill)) ++kt_fill;
    if (kt_fill >= kt_end) return;
    if (tid == 0) load_kv(stage, kt_fill);
    stage_keys(stage, kt_fill, tid, T::THREADS);
    ++kt_fill;
  };

  // ---------------- consumers: warpgroup c, rows q0 + 64c .. + 63 ----------------
  auto consume = [&](int c) {
    const int warp = (tid / 32) % 4, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;   // accumulator row group / column pair
    const int rows[2] = {q0 + 64 * c + 16 * warp + g, q0 + 64 * c + 16 * warp + g + 8};
    const int wg_first_row = q0 + 64 * c;
    const bool pingpong = WG == 2 && n_wg == 2;

    // descriptors: Q rows 64c.., K-major; K per stage K-major; V MN-major
    const uint32_t q_addr = sm90::smem_u32(q_s) + 64 * c * T::ROWB;
    const uint32_t kv_addr = sm90::smem_u32(smem + T::Q_BYTES);
    // A descriptor's start address is its low field, so a k-step's operand
    // is the tile's descriptor plus a constant (the field never carries).
    auto kmajor_step = [](int panel_bytes, int kk) -> uint64_t {
      return (T::SW128 ? (kk / 4) * panel_bytes + (kk % 4) * 32 : kk * panel_bytes) >> 4;
    };
    auto tile_desc = [](uint32_t addr, int lbo) {
      return sm90::make_desc(addr, lbo, 8 * T::ROWB, T::SWIZZLE);
    };
    const uint64_t q_desc = tile_desc(q_addr, 16);
    auto release = [&](int stage) {
      if constexpr (WG == 2) {
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[stage]);
      } else {
        __syncthreads();   // the warpgroup is done with the stage: refill it
        fill_next(stage);
      }
    };
    // O += P V of the tile in `stage`, P from registers (pf, the A operand
    // of P.V, 16 keys a k-step). ptxas serializes every wgmma of the kernel
    // if any other instruction writes an input (a descriptor, P, the scale-d
    // predicate) or an accumulator while a product of the warpgroup is in
    // flight, so the products are issued unconditionally (no branch joins
    // that would copy registers), with a constant scale-d (O starts at 0 and
    // the first P.V adds 0 . V), the registers are fenced around the issue
    // and after the wait, as CUTLASS does, and the softmax runs only once
    // both products of the turn are done (so a warpgroup does not overlap its
    // own softmax with its products; the other warpgroup's turn does).
    uint32_t pf[BK / 16][4];
    float o[DP / 2];
    auto issue_pv = [&](int stage) {
      const uint64_t v_desc =
          tile_desc(kv_addr + stage * 2 * T::KV_BYTES + T::KV_BYTES, T::KV_PANEL);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        sm90::Wgmma<DP>::rs(o, pf[kk], v_desc + (kk * 16 * T::ROWB >> 4), 1);
      sm90::wgmma_commit();
    };

    const bool bias_on = p.bias != nullptr;
    int seg_row[2] = {0, 0}, bid_row[2] = {-1, -1};
    const float* bias_row[2] = {nullptr, nullptr};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = min(rows[r], p.Sq - 1);
      if (seg_on) seg_row[r] = p.seg[key0 + row];
      if (band_on && bidb != nullptr) bid_row[r] = bidb[row];
      if (bias_on)
        bias_row[r] = p.bias + b * p.bias_bs + h * p.bias_hs + row * p.bias_qs;
    }
    // the causal cut is the band pass's when the band is on
    const bool causal_main = p.causal && !band_on;

    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;   // before any product is in flight
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) pf[kk][i] = 0u;   // the first P.V adds 0
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};

    // ping-pong: the two warpgroups take turns to issue their products (the
    // tile's S and the previous tile's P V), so one's softmax runs under the
    // other's wgmma; warpgroup 0 goes first
    if (pingpong && c == 1) sm90::bar_arrive(PINGPONG_BAR, 256);
    sm90::mbar_wait(q_full, 0);
    int it = 0, pend = 0;   // pend: the stage of the P.V still to run
    for (int kt = kt_begin; kt < kt_end; ++kt) {
      if (!tile_visible(kt)) continue;
      const int stage = it % STAGES;
      sm90::mbar_wait(&full[stage], (it / STAGES) & 1);
      const int k0 = kt * BK;

      // S = Q K^T of this tile and O += P V of the previous one (of zero P
      // on the first tile), in one turn
      const uint64_t k_desc = tile_desc(kv_addr + stage * 2 * T::KV_BYTES, 16);
      if (pingpong) sm90::bar_sync(PINGPONG_BAR + c, 256);
      sm90::reg_fence(s);
      sm90::reg_fence(o);
      sm90::reg_fence(pf);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        sm90::Wgmma<BK>::ss(s, q_desc + kmajor_step(T::Q_PANEL, kk),
                            k_desc + kmajor_step(T::KV_PANEL, kk), kk > 0);
      sm90::wgmma_commit();
      issue_pv(it > 0 ? pend : stage);
      sm90::reg_fence(s);
      sm90::reg_fence(o);
      if (pingpong) sm90::bar_arrive(PINGPONG_BAR + 1 - c, 256);
      // d = 64 without the band (the T5 sites): the tile's bias into
      // registers under the products (elsewhere the registers are needed)
      float2 bpre[EARLY_BIAS ? BK / 8 : 1][2];
      if (EARLY_BIAS && bias_on && p.bias_vec2) {
#pragma unroll
        for (int j = 0; j < (EARLY_BIAS ? BK / 8 : 0); ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int c0 = k0 + 8 * j + 2 * t4;
            bpre[j][r] = c0 + 1 < p.Sk
                ? __ldg(reinterpret_cast<const float2*>(bias_row[r] + c0))
                : make_float2(__ldg(bias_row[r] + min(c0, p.Sk - 1)),
                              __ldg(bias_row[r] + min(c0 + 1, p.Sk - 1)));
          }
      }
      if (bias_on && p.bias_vec2 && k0 + BK + 32 * t4 < p.Sk) {
#pragma unroll
        for (int r = 0; r < 2; ++r) sm90::prefetch_l1(bias_row[r] + k0 + BK + 32 * t4);
      }
      sm90::wgmma_wait<0>();
      sm90::reg_fence(s);
      sm90::reg_fence(o);
      sm90::reg_fence(pf);
      if (it > 0) release(pend);   // the previous tile's P V is done

      // scale, the key terms, bias and masks; s[4j + 2r + e] is (rows[r],
      // k0 + 8j + 2 t4 + e)
      const float* kadd = key_terms(stage);
      const int* kseg = reinterpret_cast<const int*>(kadd + BK);
      const int* kbid = kseg + BK;
      // segment ids: a tile whose keys and this warpgroup's rows all hold one
      // id keeps every score (no pass), one whose ranges do not meet keeps none
      // (no compare), and only a mixed tile takes the per-element compare.
      // With the band compiled in (no segment-id site of the port has one)
      // every visited tile compares: the registers of those instantiations
      // (168, ptxas's cap beside a producer) leave no room for the classes.
      bool seg_pass = seg_on, seg_none = false;
      if constexpr (SEG && !BAND) {
        if (seg_on) {
          const int cls = (tile_plan[kt] >> (1 + 2 * c)) & 3;
          seg_pass = cls == 1;
          seg_none = cls == 2;
        }
      }
      const bool need_mask = seg_pass || seg_none || band_on ||
                             (causal_main && k0 + BK - 1 - shift > wg_first_row);
      const bool key_on = p.kv_mask != nullptr || k0 + BK > p.Sk;   // else kadd is 0
      // The pass over the tile's scores (MASKED: with the masks where
      // need_mask). A macro, so that a segment-id tile with nothing to mask
      // runs a copy compiled without the mask code (inside the unrolled loop a
      // branch is predicated, and its instructions issued anyway), while the
      // instantiations without segment ids compile the one loop as they did,
      // and so do those with the band (every tile compares there, above).
#define FLASH_SCORE_PASS(MASKED) \
        _Pragma("unroll")                                                                   \
        for (int j = 0; j < BK / 8; ++j) {                                                  \
          const int cl = 8 * j + 2 * t4;   /* column pair in the tile */                    \
          const int c0 = k0 + cl;                                                           \
          const float2 ka =                                                                 \
              key_on ? *reinterpret_cast<const float2*>(kadd + cl) : make_float2(0.f, 0.f); \
          float bv[2][2] = {{ka.x, ka.y}, {ka.x, ka.y}};                                    \
          if (EARLY_BIAS && bias_on && p.bias_vec2) {                                       \
            _Pragma("unroll")                                                               \
            for (int r = 0; r < 2; ++r) {                                                   \
              bv[r][0] += bpre[EARLY_BIAS ? j : 0][r].x;                                    \
              bv[r][1] += bpre[EARLY_BIAS ? j : 0][r].y;                                    \
            }                                                                               \
          } else if (bias_on) {                                                             \
            _Pragma("unroll")                                                               \
            for (int r = 0; r < 2; ++r) {                                                   \
              if (p.bias_vec2 && c0 + 1 < p.Sk) {                                           \
                const float2 pr = __ldg(reinterpret_cast<const float2*>(bias_row[r] + c0)); \
                bv[r][0] += pr.x;                                                           \
                bv[r][1] += pr.y;                                                           \
              } else {                                                                      \
                bv[r][0] += __ldg(bias_row[r] + min(c0, p.Sk - 1) * p.bias_ks);             \
                bv[r][1] += __ldg(bias_row[r] + min(c0 + 1, p.Sk - 1) * p.bias_ks);         \
              }                                                                             \
            }                                                                               \
          }                                                                                 \
          int2 ks = make_int2(0, 0), kb = make_int2(-1, -1);                                \
          if (seg_pass) ks = *reinterpret_cast<const int2*>(kseg + cl);                     \
          if (band_on && bidb != nullptr) kb = *reinterpret_cast<const int2*>(kbid + cl);   \
          _Pragma("unroll")                                                                 \
          for (int e = 0; e < 2; ++e) {                                                     \
            const int col = c0 + e;                                                         \
            _Pragma("unroll")                                                               \
            for (int r = 0; r < 2; ++r) {                                                   \
              const int row = rows[r];                                                      \
              float x = fmaf(s[4 * j + 2 * r + e], p.scale, bv[r][e]);                      \
              if (rel_on) x += relb[min(col, p.Sk - 1) - min(row, last_row) + last_row];    \
              if (MASKED && need_mask) {                                                    \
                bool keep = !seg_none;                                                      \
                if (causal_main) keep = keep && col - shift <= row;                         \
                if (seg_pass) keep = keep && (e ? ks.y : ks.x) == seg_row[r];               \
                if (band_on) {                                                              \
                  bool in = col - shift <= row &&                                           \
                            (p.window <= 0 || col - shift > row - p.window);                \
                  if (!in && bidb != nullptr)                                               \
                    in = bid_row[r] >= 0 && (e ? kb.y : kb.x) == bid_row[r];                \
                  keep = keep && in;                                                        \
                }                                                                           \
                if (!keep) x = -INFINITY;                                                   \
              }                                                                             \
              s[4 * j + 2 * r + e] = x;                                                     \
            }                                                                               \
          }                                                                                 \
        }
      if constexpr (SEG && !BAND) {
        if (need_mask) {
          FLASH_SCORE_PASS(true)
        } else {
          FLASH_SCORE_PASS(false)
        }
      } else {
        FLASH_SCORE_PASS(true)
      }
#undef FLASH_SCORE_PASS

      // online softmax: the 4 threads of a row group share each row
      float mu[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = fmaxf(m_run[r], row_max(s, r));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mu[r] = (mx == -INFINITY ? 0.f : mx) * LOG2E;   // all masked so far: p = 0
        alpha[r] = exp2_approx(fmaf(m_run[r], LOG2E, -mu[r]));
        m_run[r] = mx;
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[4 * j + i] = exp2_approx(fmaf(s[4 * j + i], LOG2E, -mu[i / 2]));
        pf[j / 2][(j % 2) * 2] = pack_bf16(s[4 * j], s[4 * j + 1]);
        pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float rs = row_sum(s, r);
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        l_run[r] = l_run[r] * alpha[r] + rs;
      }

#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
      pend = stage;
      ++it;
    }
    // the last tile's P V (with no tile: zero P over stage 0, whose O the
    // epilogue does not read)
    if (pingpong) sm90::bar_sync(PINGPONG_BAR + c, 256);
    sm90::reg_fence(o);
    sm90::reg_fence(pf);
    sm90::wgmma_fence();
    issue_pv(pend);
    sm90::reg_fence(o);
    if (pingpong) sm90::bar_arrive(PINGPONG_BAR + 1 - c, 256);
    sm90::wgmma_wait<0>();
    sm90::reg_fence(o);
    if (it > 0) release(pend);
    if (pingpong && c == 0) sm90::bar_sync(PINGPONG_BAR, 256);   // the partner's last turn

    // epilogue: divide by the row sum; a fully masked row (sum 0) writes 0
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= p.Sq) continue;
      const bool none = l_run[r] == 0.f;   // O may never have been written
      const float l = none ? 1.f : l_run[r];
      __nv_bfloat16* orow = p.o + b * p.o_bs + rows[r] * p.o_rs + h * p.o_hs;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        if (8 * j + 2 * t4 < D)
          *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t4) =
              none ? 0u : pack_bf16(o[4 * j + 2 * r] / l, o[4 * j + 2 * r + 1] / l);
      }
    }
  };

  if constexpr (WG == 2) {
    if (tid < 128) {
      // ---------------- producer warpgroup ----------------
      sm90::setmaxnreg_dec<40>();
      if (tid == 0) {
        // the Q tile, then K and V of each tile into the ring
        sm90::tma_prefetch(&tq);
        sm90::tma_prefetch(&tk);
        sm90::tma_prefetch(&tv);
        if (!seg_on) {   // else issued before the segment-id staging
          sm90::mbar_expect_tx(q_full, T::Q_BYTES);
          load_tile(q_s, &tq, q_full, p.axis[0], T::NP, T::Q_PANEL, T::PW, h, q0, b);
        }
        int it = 0;
        for (int kt = kt_begin; kt < kt_end; ++kt) {
          if (!tile_visible(kt)) continue;
          const int stage = it % STAGES;
          if (it >= STAGES) sm90::mbar_wait(&empty[stage], ((it / STAGES) - 1) & 1);
          load_kv(stage, kt);
          ++it;
        }
      } else if (tid >= 32 && tid < 64) {
        // warp 1: each tile's key terms, beside the TMA copies
        int it = 0;
        for (int kt = kt_begin; kt < kt_end; ++kt) {
          if (!tile_visible(kt)) continue;
          const int stage = it % STAGES;
          if (it >= STAGES) sm90::mbar_wait(&empty[stage], ((it / STAGES) - 1) & 1);
          stage_keys(stage, kt, tid - 32, 32);
          sm90::mbar_arrive(&full[stage]);
          ++it;
        }
      }
    } else {
      sm90::setmaxnreg_inc<232>();
      const int c = tid / 128 - 1;
      if (c < n_wg) consume(c);
    }
  } else {
    // one warpgroup: thread 0 loads, every thread stages the key terms, and
    // a stage is refilled once the warpgroup has released it
    if (tid == 0 && !seg_on) {   // else issued before the segment-id staging
      sm90::mbar_expect_tx(q_full, T::Q_BYTES);
      load_tile(q_s, &tq, q_full, p.axis[0], T::NP, T::Q_PANEL, T::PW, h, q0, b);
    }
    for (int s = 0; s < STAGES; ++s) fill_next(s);
    __syncthreads();
    consume(0);
  }
}

// ---------------------------------------------------------------------------
// Host side: the tensor maps and the launch. geo holds, for q, k and v, 16
// int64 each as ops/attention.py tma_geometry packs them: the base address,
// the 4 extents (head dim first), the 3 byte strides of dims 1..3, the 4 box
// sizes, the swizzle in bytes, and the map dim (1..3) of the head, the row and
// the batch axis. The q box's rows say the variant: 64 (one consumer
// warpgroup, Sq <= 64) or 128.

constexpr int GEO = 16;

// Encode one operand's map; its box must be the kernel's panel of `rows`.
template <int D, int WG>
cudaError_t encode(CUtensorMap* map, int (&axis)[3], const long long* g, int rows) {
  using T = Tile<D, WG>;
  const sm90::EncodeTiled fn = sm90::encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const long long swizzle = T::SW128 ? 128 : 32;
  if (g[8] != T::PW || g[9] * g[10] * g[11] != rows || g[12] != swizzle)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {(cuuint64_t)g[1], (cuuint64_t)g[2], (cuuint64_t)g[3],
                              (cuuint64_t)g[4]};
  const cuuint64_t strides[3] = {(cuuint64_t)g[5], (cuuint64_t)g[6], (cuuint64_t)g[7]};
  const cuuint32_t box[4] = {(cuuint32_t)g[8], (cuuint32_t)g[9], (cuuint32_t)g[10],
                             (cuuint32_t)g[11]};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) axis[i] = static_cast<int>(g[13 + i]);
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                          reinterpret_cast<void*>(g[0]), dims, strides, box, unit,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          T::SW128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D, int WG, bool SEG, bool BAND, bool REL>
cudaError_t launch_variant(const long long* geo, Params p, int extra_smem,
                           cudaStream_t stream) {
  using T = Tile<D, WG>;
  CUtensorMap maps[3];
  const int rows[3] = {T::BQ, T::BK, T::BK};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = encode<D, WG>(&maps[i], p.axis[i], geo + i * GEO, rows[i]);
    if (err != cudaSuccess) return err;
  }
  auto kernel = attention_kernel<D, WG, SEG, BAND, REL>;
  // segment ids: the key tiles' plan
  const int seg_smem = SEG && p.seg != nullptr ? seg_plan_bytes<T::BK>(p.Sk) : 0;
  const int smem = T::SMEM + extra_smem + seg_smem;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  p.q_tiles = (p.Sq + T::BQ - 1) / T::BQ;
  const long long blocks = (long long)p.q_tiles * p.H * p.B;
  kernel<<<static_cast<unsigned>(blocks), T::THREADS, smem, stream>>>(maps[0], maps[1],
                                                                       maps[2], p);
  return cudaGetLastError();
}

// Launch the variant the q map's box names; extra_smem: the REL kernels'
// staged bias (launch_variant adds the segment-id table). Returns
// cudaGetLastError() after the launch.
template <int D, bool SEG, bool BAND, bool REL>
cudaError_t launch(const long long* geo, const Params& p, int extra_smem, cudaStream_t stream) {
  if (geo[9] * geo[10] * geo[11] == Tile<D, 1>::BQ)
    return launch_variant<D, 1, SEG, BAND, REL>(geo, p, extra_smem, stream);
  return launch_variant<D, 2, SEG, BAND, REL>(geo, p, extra_smem, stream);
}

// The arguments both C entries take, into Params (the rel pointers null for
// the flat entry).
inline Params make_params(void* o, const void* bias, const void* kv_mask, const void* seg,
                          const void* bidir, const void* rel, const void* rel_bucket, int B,
                          int H, int KVH, int Sq, int Sk, int num_buckets, long long o_bs,
                          long long o_rs, long long o_hs, long long bias_bs, long long bias_hs,
                          long long bias_qs, long long bias_ks, int bias_vec2, int causal,
                          int window, int head_major, float scale) {
  Params p = {};
  p.o = static_cast<__nv_bfloat16*>(o);
  p.bias = static_cast<const float*>(bias);
  p.kv_mask = static_cast<const int*>(kv_mask);
  p.seg = static_cast<const int*>(seg);
  p.bidir = static_cast<const int*>(bidir);
  p.rel = static_cast<const float*>(rel);
  p.rel_bucket = static_cast<const int*>(rel_bucket);
  p.o_bs = o_bs; p.o_rs = o_rs; p.o_hs = o_hs;
  p.bias_bs = bias_bs; p.bias_hs = bias_hs; p.bias_qs = bias_qs; p.bias_ks = bias_ks;
  p.B = B;
  p.H = H;
  p.kv_rep = H / KVH;
  p.Sq = Sq;
  p.Sk = Sk;
  p.num_buckets = num_buckets;
  p.bias_vec2 = bias_vec2;
  p.causal = causal;
  p.window = window;
  p.head_major = head_major;
  p.scale = scale;
  return p;
}

}  // namespace flash
