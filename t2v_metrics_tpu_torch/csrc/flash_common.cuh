// The flash attention body shared by the two attention kernels of the port:
// flash_flat.cu (the flat (B, S, H*D) layout) and flash_attention.cu (the
// per-head (B, H, S, D) layout), both instantiations of attention_kernel.
// The flat one reads q, k and v through a base pointer, a column offset and
// batch and row strides (head h at column h*D), the per-head one through
// batch, head and row strides; both need a unit column stride. They differ
// in how the wrapper fills Params, in the PER_HEAD flag and in which terms
// they compile in. See the two sources for what each replaces.
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
// Design: one block of 4 warps per (64-row q tile, head, batch item). K and
// V are streamed through shared memory in 64-key tiles; each warp's 16x64
// scores stay in registers, the online softmax keeps an fp32 running max and
// sum per row, and the probabilities go straight from the score accumulators
// into the A fragments of P.V (the m16n8k16 C layout is the A layout of the
// next product). Rows of shared memory are padded by 16 bytes so fragment
// loads are free of bank conflicts; V is stored transposed so its B
// fragments are 32-bit loads. Tiles live in dynamic shared memory (past 48 KB
// at d >= 128). A head dim that is not a multiple of 16 (72) runs its Q.K^T
// k-steps over DP = 80 columns: the Q and K tiles load the head's 72 columns
// and zero columns 72..79.
//
// Head dim 256: up to d=128 each warp keeps its 16 q rows as A fragments in
// registers for the whole pass (KS x 4 registers). At d=256 that is 64
// registers on top of the 128 of the O accumulator (32 n-tiles x 4) and the
// 32 of the score tile, past the 255 a thread may hold. So at d > 128 the Q
// tile stays in shared memory (it is never overwritten) and each k-step
// loads its A fragment from there (4 lds.32, once per k-step for all 8 key
// n-tiles): ~200 registers, no spill, 104 KB of shared memory a block.
//
// Terms compiled in by template flags, so that a kernel without them keeps
// its instruction stream: SEG (segment ids), BAND (local window and the
// bidir overlay) and REL (the in-kernel T5 relative-position bias). PER_HEAD
// is the per-head entry: head strides and the bias's batch stride come from
// Params, and a term that is compiled in also checks its runtime pointer
// (that kernel compiles all three into one instantiation). Without it (the
// flat entry) head h sits at column h*D of its row, the bias is (1, H, Sq,
// Sk) and the launcher guarantees each compiled-in term is present.
//
// The flat instantiations without BAND compile to the machine code the flat
// kernel had before the per-head entry shared this body (the same opcode
// sequence, by scripts/torch_attention_ab.py's digests, and the same times).
// ptxas schedules this loop by small things, so three choices keep it so:
// the body is the kernel itself and reads its own parameter (as an inlined
// function reading Params through a reference, some earlier sites ran 3-15%
// slower), the Params fields the flat kernel reads keep their order, and the
// mask pass reads p.causal itself.
//
// Key tiles: with causal the block stops at the last key tile its rows can
// see; with a window it starts at the first. The bidir overlay can reopen
// tiles on either side: the block finds the range of keys whose id lies
// between the smallest and largest non-negative id of its rows (a superset
// of the keys it can reopen) and also visits those tiles.
//
// The T5 bias: the bucket of each distance col - row is computed once per
// call by the wrapper (ops/position.py relative_position_bucket, the plain
// version's own function, so the buckets agree exactly; a CUDA logf one ulp
// off XLA's would flip buckets at their exact edges) into an int32 table of
// Sq + Sk - 1 entries. Each block stages its head's bias for the distances
// its rows can see (Sk + 63 floats) in shared memory, so the (H, Sq, Sk)
// bias never exists in HBM and a tile reads it from shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int BQ = 64;       // q rows per block: 4 warps x 16
constexpr int BK = 64;       // keys per shared-memory tile
constexpr int LDV = BK + 8;  // padded row length of the transposed V tile
constexpr int THREADS = 128;
constexpr int NONE = 1 << 30;

// The flat kernel's fields come first, in the order (so at the constant-bank
// offsets) they had before the per-head kernel shared the body.
struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  const float* bias;        // fp32, read through the bias strides
  const int* kv_mask;       // (B, Sk) int32
  const int* seg;           // (B, Sk) int32, Sq == Sk
  int H, kv_rep, Sq, Sk;
  long long q_bs, q_rs, q_off, k_bs, k_rs, k_off, v_bs, v_rs, v_off;  // off: flat
  long long o_bs, o_rs, bias_hs, bias_qs, bias_ks;
  int causal;
  float scale;
  // the band's and the per-head kernel's
  const int* bidir;         // (B, Sk) int32, Sq == Sk
  const float* rel;         // (H, num_buckets) fp32
  const int* rel_bucket;    // (Sq + Sk - 1) int32: bucket of col - row + Sq - 1
  int num_buckets, window;  // window 0: none
  long long q_hs, k_hs, v_hs, o_hs, bias_bs;
};

// Head dim D rounded up to the 16-wide k-step of m16n8k16.
template <int D>
__host__ __device__ constexpr int padded_dim() {
  return (D + 15) / 16 * 16;
}

// Dynamic shared memory of the tiles: Q and K tiles of DP + 8 columns and
// the transposed V tile of D rows of BK + 8 keys, all bf16. The REL kernels
// add (Sk + BQ) floats after them.
template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return ((BQ + BK) * (padded_dim<D>() + 8) + D * LDV) * 2;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

template <int D, bool SEG, bool BAND, bool REL, bool PER_HEAD>
__global__ void __launch_bounds__(THREADS) attention_kernel(const Params p) {
  constexpr int DP = padded_dim<D>();
  constexpr int LD = DP + 8;     // padded row length of the Q and K tiles
  constexpr int CH = DP / 8;     // 16-byte chunks per Q/K tile row
  constexpr int KS = DP / 16;    // k-steps of Q.K^T
  constexpr int NT = D / 8;      // 8-column output tiles of P.V
  constexpr bool QREG = D <= 128;  // Q fragments in registers (see above)
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int ranges[4];      // bidir: row id min / max, key min / max
  auto Qs = reinterpret_cast<__nv_bfloat16 (*)[LD]>(smem);
  auto Ks = reinterpret_cast<__nv_bfloat16 (*)[LD]>(smem + BQ * LD * 2);
  auto Vt = reinterpret_cast<__nv_bfloat16 (*)[LDV]>(  // V transposed: [d][key]
      smem + (BQ + BK) * LD * 2);
  float* relb = reinterpret_cast<float*>(smem + smem_bytes<D>());

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;   // mma fragment row group / column pair
  const int kvh = h / p.kv_rep;

  // head strides: the flat layout's D, known at compile time
  const long long q_hs = PER_HEAD ? p.q_hs : D, k_hs = PER_HEAD ? p.k_hs : D,
                  v_hs = PER_HEAD ? p.v_hs : D, o_hs = PER_HEAD ? p.o_hs : D;
  const __nv_bfloat16* qb = p.q + b * p.q_bs + p.q_off + h * q_hs;
  const __nv_bfloat16* kb = p.k + b * p.k_bs + p.k_off + kvh * k_hs;
  const __nv_bfloat16* vb = p.v + b * p.v_bs + p.v_off + kvh * v_hs;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // Q tile -> shared (16-byte chunks; rows past Sq and columns past D
  // zero-filled, the latter only when D is not a multiple of 16)
  for (int i = tid; i < BQ * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = zero;
    if ((DP == D || c < D) && q0 + r < p.Sq)
      val = *reinterpret_cast<const uint4*>(qb + (q0 + r) * p.q_rs + c);
    *reinterpret_cast<uint4*>(&Qs[r][c]) = val;
  }
  // T5 bias of this head for the distances these rows see: relb[j] is the
  // bias of col - row = j + jmin - (Sq - 1)
  const bool rel_on = REL && (!PER_HEAD || p.rel != nullptr);
  int jmin = 0;
  if (rel_on) {
    const int last_row = min(q0 + BQ, p.Sq) - 1;
    jmin = p.Sq - 1 - last_row;
    const int count = p.Sk + last_row - q0;
    const float* col = p.rel + (long long)h * p.num_buckets;
    for (int i = tid; i < count; i += THREADS) relb[i] = col[p.rel_bucket[jmin + i]];
  }
  __syncthreads();

  const int wr = warp * 16;
  uint32_t qf[QREG ? KS : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int c = kk * 16 + t4 * 2;
      qf[kk][0] = ld32(&Qs[wr + g][c]);
      qf[kk][1] = ld32(&Qs[wr + g + 8][c]);
      qf[kk][2] = ld32(&Qs[wr + g][c + 8]);
      qf[kk][3] = ld32(&Qs[wr + g + 8][c + 8]);
    }
  }

  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};
  const int shift = p.Sk - p.Sq;
  const bool seg_on = SEG && (!PER_HEAD || p.seg != nullptr);
  const int* segb = seg_on ? p.seg + (long long)b * p.Sk : nullptr;
  int seg_row[2] = {0, 0};
  if (seg_on) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      seg_row[r] = rows[r] < p.Sq ? segb[rows[r]] : 0;
  }

  // key tiles [kt_lo, n_tiles) of the causal / window band
  int n_tiles = (p.Sk + BK - 1) / BK;
  if (p.causal) {
    const int last_row = min(q0 + BQ, p.Sq) - 1;
    const int last_key = min(p.Sk - 1, last_row + shift);
    n_tiles = last_key < 0 ? 0 : last_key / BK + 1;
  }
  int kt_lo = 0;
  const bool band_on = BAND && (!PER_HEAD || p.window > 0 || p.bidir != nullptr);
  if (BAND && p.window > 0) kt_lo = max(0, q0 + shift - p.window + 1) / BK;
  // key tiles [ob_lo, ob_hi] the bidir overlay may reopen
  int ob_lo = NONE, ob_hi = -1;
  const int* bidb = BAND && p.bidir != nullptr ? p.bidir + (long long)b * p.Sk : nullptr;
  int bid_row[2] = {-1, -1};
  if (BAND && bidb != nullptr) {
    if (tid == 0) {
      ranges[0] = NONE; ranges[1] = -1; ranges[2] = NONE; ranges[3] = -1;
    }
    __syncthreads();
    if (tid < BQ && q0 + tid < p.Sq) {
      const int id = bidb[q0 + tid];
      if (id >= 0) {
        atomicMin(&ranges[0], id);
        atomicMax(&ranges[1], id);
      }
    }
    __syncthreads();
    const int lo = ranges[0], hi = ranges[1];
    if (hi >= 0) {
      for (int c = tid; c < p.Sk; c += THREADS) {
        const int id = bidb[c];
        if (id >= lo && id <= hi) {
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
#pragma unroll
    for (int r = 0; r < 2; ++r)
      bid_row[r] = rows[r] < p.Sq ? bidb[rows[r]] : -1;
  }
  // with the band pass on, causal is applied there (OR-ed with the overlay);
  // without BAND the mask pass reads p.causal itself (a copy held across the
  // loop cost the T5 site ~3%)
  const int causal_main = band_on ? 0 : p.causal;
  // the band's tiles and the ones the overlay reopens; without BAND the
  // loop is [0, n_tiles), as before the band existed
  int kt_begin = 0, kt_end = n_tiles;
  if constexpr (BAND) {
    kt_begin = min(kt_lo, ob_lo);
    kt_end = max(n_tiles, ob_hi + 1);
  }

  // each key tile: K/V to shared memory, the scores, the masks, the online
  // softmax and P.V
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    if constexpr (BAND) {
      if ((kt < kt_lo || kt >= n_tiles) && (kt < ob_lo || kt > ob_hi)) continue;
    }
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < BK * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool col_in = DP == D || c < D;   // a column of this head
      uint4 kv = zero, vv = zero;
      if (col_in && k0 + r < p.Sk) {
        kv = *reinterpret_cast<const uint4*>(kb + (k0 + r) * p.k_rs + c);
        vv = *reinterpret_cast<const uint4*>(vb + (k0 + r) * p.v_rs + c);
      }
      *reinterpret_cast<uint4*>(&Ks[r][c]) = kv;
      if (col_in) {
        const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
        for (int j = 0; j < 8; ++j) Vt[c + j][r] = ve[j];
      }
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[8][4];
    if constexpr (QREG) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const __nv_bfloat16* kr = &Ks[nt * 8 + g][kk * 16 + t4 * 2];
          mma16816(s[nt], qf[kk], ld32(kr), ld32(kr + 8));
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int c = kk * 16 + t4 * 2;
        const uint32_t a[4] = {ld32(&Qs[wr + g][c]), ld32(&Qs[wr + g + 8][c]),
                               ld32(&Qs[wr + g][c + 8]), ld32(&Qs[wr + g + 8][c + 8])};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const __nv_bfloat16* kr = &Ks[nt * 8 + g][c];
          mma16816(s[nt], a, ld32(kr), ld32(kr + 8));
        }
      }
    }

    // scale, bias and masks; e = 0,1 belong to rows[0], e = 2,3 to rows[1]
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rows[e >> 1];
        const int col = k0 + nt * 8 + t4 * 2 + (e & 1);
        bool keep = col < p.Sk;
        if (keep && p.kv_mask != nullptr)
          keep = p.kv_mask[(long long)b * p.Sk + col] != 0;
        if (keep && (BAND ? causal_main : p.causal)) keep = col - shift <= row;
        float x = s[nt][e] * p.scale;
        // p.bias itself (a constant-bank operand) and not a per-block
        // pointer derived from it: a register pointer's null test is a
        // 64-bit compare per score element, and indexing through it cost
        // the T5 site ~8%; the flat bias has no batch term
        if (keep && p.bias != nullptr && row < p.Sq)
          x += p.bias[(PER_HEAD ? b * p.bias_bs : 0) + h * p.bias_hs +
                      row * p.bias_qs + col * p.bias_ks];
        if (rel_on && keep && row < p.Sq) x += relb[col - row + p.Sq - 1 - jmin];
        s[nt][e] = keep ? x : -INFINITY;
      }
    }
    // segment ids in a pass of their own, compiled only into the SEG
    // instantiations, so that the kernel without them is unchanged
    if (seg_on) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + nt * 8 + t4 * 2 + (e & 1);
          if (col < p.Sk && segb[col] != seg_row[e >> 1]) s[nt][e] = -INFINITY;
        }
      }
    }
    // the causal / window band OR the bidir overlay, likewise on its own
    if (band_on) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = rows[e >> 1];
          const int col = k0 + nt * 8 + t4 * 2 + (e & 1);
          bool keep = col - shift <= row &&
                      (p.window <= 0 || col - shift > row - p.window);
          if (!keep && bidb != nullptr && col < p.Sk)
            keep = bid_row[e >> 1] >= 0 && bidb[col] == bid_row[e >> 1];
          if (!keep) s[nt][e] = -INFINITY;
        }
      }
    }

    // online softmax: the 4 threads of a row group share each row
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float mu[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      mu[r] = mx[r] == -INFINITY ? 0.f : mx[r];   // all masked so far: p = 0
      alpha[r] = __expf(m_run[r] - mu[r]);
      m_run[r] = mx[r];
    }

    float rs[2] = {0.f, 0.f};
    uint32_t pf[4][4];   // P as the A fragments of P.V, 16 keys per k-step
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float p0 = __expf(s[nt][0] - mu[0]);
      const float p1 = __expf(s[nt][1] - mu[0]);
      const float p2 = __expf(s[nt][2] - mu[1]);
      const float p3 = __expf(s[nt][3] - mu[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      const int kk = nt >> 1, hi = (nt & 1) * 2;
      pf[kk][hi] = pack_bf16(p0, p1);
      pf[kk][hi + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l_run[r] = l_run[r] * alpha[r] + rs[r];
    }

    // O = O * alpha + P V
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const __nv_bfloat16* vr = &Vt[nt * 8 + g][kk * 16 + t4 * 2];
        mma16816(acc[nt], pf[kk], ld32(vr), ld32(vr + 8));
      }
    }
  }

  // epilogue: divide by the row sum; a fully masked row (sum 0) writes 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= p.Sq) continue;
    const float l = l_run[r] == 0.f ? 1.f : l_run[r];
    __nv_bfloat16* orow = p.o + b * p.o_bs + rows[r] * p.o_rs + h * o_hs;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      *reinterpret_cast<uint32_t*>(orow + nt * 8 + t4 * 2) =
          pack_bf16(acc[nt][2 * r] / l, acc[nt][2 * r + 1] / l);
    }
  }
}

// Opt in to the block's dynamic shared memory (above 48 KB a launch is
// refused without it), launch, and return cudaGetLastError().
template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, int B, int smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, B);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace flash
