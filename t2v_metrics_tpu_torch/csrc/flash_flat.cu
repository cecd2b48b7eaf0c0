// Flat flash attention for Hopper (sm_90a), head dim 64, 80 or 128, bf16 in
// and out.
//
// Replaces the TPU kernel t2v_metrics_tpu/ops/attention.py:_flash_flat_kernel
// (entered through flash_attention_flat / flash_attention_flat_packed).
//
// Layout. q, k and v are read in place from the flat (B, S, cols) projection
// layout: each comes as a base pointer with a batch stride, a row stride and
// a column offset, so the packed (B, S, (H+2KvH)*D) qkv projection and three
// separate arrays are one kernel, and nothing is sliced into a copy. Head h
// reads q columns off_q + h*D and k/v columns off_kv + (h / kv_rep)*D (GQA).
// The output is (B, Sq, H*D) bf16 with head h at column h*D.
//
// Semantics (as the TPU kernel and attention_flat_reference):
//   s = (q . k) * scale + bias[h, row, col]      (fp32; bias optional)
//   masked out: col >= Sk, kv_mask[b, col] == 0, seg[b, row] != seg[b, col]
//   (square attention only; -1 matches -1, as in the TPU kernel), and with
//   causal the keys after the end-aligned diagonal (col - (Sk - Sq) > row)
//   p = exp(s - running max) in fp32, rounded to bf16 before p . v
//   out = (sum p.v) / (sum p), and 0 for a row whose keys are all masked.
//
// What bounds it on the H100: at the clip-flant5 shapes (d=64, S<=640) the
// two products are 2*64 flops per score element each, while the fp32 softmax
// does a max, a subtract, an exp and a sum per element and the T5 bias adds a
// 4-byte read per element. So the kernel is bound by the softmax work and the
// bias stream, not by the tensor cores, and the (Sq, Sk) score matrix must
// never reach HBM. At the Qwen2.5-VL shapes (d=80 ViT over up to 5120 keys,
// d=128 decoder prefill) the products weigh more per score element, and the
// unpipelined K/V tile loads and mma.sync (not wgmma) bound it instead.
//
// What the design does about it: one block of 4 warps per (64-row q tile,
// head, batch item). Each warp keeps its 16 q rows as mma.sync A fragments in
// registers for the whole pass. K and V are streamed through shared memory in
// 64-key tiles; each tile's 16x64 scores per warp stay in registers, the
// online softmax keeps an fp32 running max and sum per row, and the
// probabilities go straight from the score accumulators into the A fragments
// of P.V (the m16n8k16 C layout is the A layout of the next product). Rows of
// shared memory are padded by 16 bytes so that fragment loads are free of
// bank conflicts. V is stored transposed in shared memory so its B fragments
// are 32-bit loads. With causal masking the block stops at the last key tile
// its rows can see. The head dim is a template parameter (80 = 5 x 16 fits
// the m16n8k16 k-steps); the tiles live in dynamic shared memory, because at
// d=128 they pass the 48 KB static limit. Segment ids are a second template
// parameter: one extra int per key of each tile, compared with the two
// segment ids of each thread's rows in a pass after the other masks (in the
// per-element mask loop they cost the d=64 T5 site ~13%); no key tile is
// skipped (the ViT's windowed layers over a whole 5120-row
// bucket compute every tile and mask all but their window). The TPU kernel's
// head-group planning and its ones-column denominator on v are MXU and VMEM
// devices and are not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // q rows per block: 4 warps x 16
constexpr int BK = 64;       // keys per shared-memory tile
constexpr int LDV = BK + 8;  // padded row length of the transposed V tile
constexpr int THREADS = 128;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  const float* bias;
  const int* kv_mask;
  const int* seg;
  int H, kv_rep, Sq, Sk;
  long long q_bs, q_rs, q_off, k_bs, k_rs, k_off, v_bs, v_rs, v_off;
  long long o_bs, o_rs, bias_hs, bias_qs, bias_ks;
  int causal;
  float scale;
};

// Dynamic shared memory of one block: Q and K tiles of D + 8 columns, and
// the transposed V tile of D rows of BK + 8 keys, all bf16.
template <int D>
constexpr int smem_bytes() {
  return ((BQ + BK) * (D + 8) + D * LDV) * 2;
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

template <int D, bool SEG>
__global__ void __launch_bounds__(THREADS)
flash_flat_kernel(const Params p) {
  constexpr int LD = D + 8;      // padded row length of the Q and K tiles
  constexpr int CH = D / 8;      // 16-byte chunks per row
  constexpr int KS = D / 16;     // k-steps of Q.K^T
  constexpr int NT = D / 8;      // 8-column output tiles of P.V
  extern __shared__ __align__(16) unsigned char smem[];
  auto Qs = reinterpret_cast<__nv_bfloat16 (*)[LD]>(smem);
  auto Ks = reinterpret_cast<__nv_bfloat16 (*)[LD]>(smem + BQ * LD * 2);
  auto Vt = reinterpret_cast<__nv_bfloat16 (*)[LDV]>(  // V transposed: [d][key]
      smem + (BQ + BK) * LD * 2);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;   // mma fragment row group / column pair
  const int kvh = h / p.kv_rep;

  const __nv_bfloat16* qb = p.q + b * p.q_bs + p.q_off + (long long)h * D;
  const __nv_bfloat16* kb = p.k + b * p.k_bs + p.k_off + (long long)kvh * D;
  const __nv_bfloat16* vb = p.v + b * p.v_bs + p.v_off + (long long)kvh * D;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // Q tile -> shared (16-byte chunks, rows past Sq zero-filled)
  for (int i = tid; i < BQ * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = zero;
    if (q0 + r < p.Sq)
      val = *reinterpret_cast<const uint4*>(qb + (q0 + r) * p.q_rs + c);
    *reinterpret_cast<uint4*>(&Qs[r][c]) = val;
  }
  __syncthreads();

  const int wr = warp * 16;
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c = kk * 16 + t4 * 2;
    qf[kk][0] = ld32(&Qs[wr + g][c]);
    qf[kk][1] = ld32(&Qs[wr + g + 8][c]);
    qf[kk][2] = ld32(&Qs[wr + g][c + 8]);
    qf[kk][3] = ld32(&Qs[wr + g + 8][c + 8]);
  }

  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};
  const int shift = p.Sk - p.Sq;
  const int* segb = SEG ? p.seg + (long long)b * p.Sk : nullptr;
  int seg_row[2] = {0, 0};
  if (SEG) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      seg_row[r] = rows[r] < p.Sq ? segb[rows[r]] : 0;
  }

  int n_tiles = (p.Sk + BK - 1) / BK;
  if (p.causal) {
    const int last_row = min(q0 + BQ, p.Sq) - 1;
    const int last_key = min(p.Sk - 1, last_row + shift);
    n_tiles = last_key < 0 ? 0 : last_key / BK + 1;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < BK * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 kv = zero, vv = zero;
      if (k0 + r < p.Sk) {
        kv = *reinterpret_cast<const uint4*>(kb + (k0 + r) * p.k_rs + c);
        vv = *reinterpret_cast<const uint4*>(vb + (k0 + r) * p.v_rs + c);
      }
      *reinterpret_cast<uint4*>(&Ks[r][c]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[c + j][r] = ve[j];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const __nv_bfloat16* kr = &Ks[nt * 8 + g][kk * 16 + t4 * 2];
        mma16816(s[nt], qf[kk], ld32(kr), ld32(kr + 8));
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
        if (keep && p.causal) keep = col - shift <= row;
        float x = s[nt][e] * p.scale;
        if (keep && p.bias != nullptr && row < p.Sq)
          x += p.bias[h * p.bias_hs + row * p.bias_qs + col * p.bias_ks];
        s[nt][e] = keep ? x : -INFINITY;
      }
    }
    // segment ids in a pass of their own, compiled only into the SEG
    // instantiations, so that the kernel without them is unchanged
    if (SEG) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + nt * 8 + t4 * 2 + (e & 1);
          if (col < p.Sk && segb[col] != seg_row[e >> 1]) s[nt][e] = -INFINITY;
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
    __nv_bfloat16* orow = p.o + b * p.o_bs + rows[r] * p.o_rs + (long long)h * D;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      *reinterpret_cast<uint32_t*>(orow + nt * 8 + t4 * 2) =
          pack_bf16(acc[nt][2 * r] / l, acc[nt][2 * r + 1] / l);
    }
  }
}

template <int D, bool SEG>
cudaError_t launch_kernel(const Params& p, int B, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  // above 48 KB a block gets dynamic shared memory only after this opt-in;
  // without it the launch is refused
  cudaError_t err = cudaFuncSetAttribute(
      flash_flat_kernel<D, SEG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, B);
  flash_flat_kernel<D, SEG><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  return p.seg != nullptr ? launch_kernel<D, true>(p, B, stream)
                          : launch_kernel<D, false>(p, B, stream);
}

}  // namespace

// Strides and offsets are in elements. Pointers and every offset and stride
// of q, k, v and o must keep 16-byte alignment (the wrapper checks). seg is
// an int32 (B, Sk) array or null, and needs Sq == Sk. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a head dim
// other than 64, 80 or 128).
extern "C" int flash_flat_forward(
    const void* q, const void* k, const void* v, void* o, const void* bias,
    const void* kv_mask, const void* seg, int B, int H, int KVH, int Sq,
    int Sk, int D,
    long long q_bs, long long q_rs, long long q_off,
    long long k_bs, long long k_rs, long long k_off,
    long long v_bs, long long v_rs, long long v_off,
    long long o_bs, long long o_rs,
    long long bias_hs, long long bias_qs, long long bias_ks,
    int causal, float scale, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.bias = static_cast<const float*>(bias);
  p.kv_mask = static_cast<const int*>(kv_mask);
  p.seg = static_cast<const int*>(seg);
  p.H = H;
  p.kv_rep = H / KVH;
  p.Sq = Sq;
  p.Sk = Sk;
  p.q_bs = q_bs; p.q_rs = q_rs; p.q_off = q_off;
  p.k_bs = k_bs; p.k_rs = k_rs; p.k_off = k_off;
  p.v_bs = v_bs; p.v_rs = v_rs; p.v_off = v_off;
  p.o_bs = o_bs; p.o_rs = o_rs;
  p.bias_hs = bias_hs; p.bias_qs = bias_qs; p.bias_ks = bias_ks;
  p.causal = causal;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return static_cast<int>(launch<64>(p, B, s));
    case 80: return static_cast<int>(launch<80>(p, B, s));
    case 128: return static_cast<int>(launch<128>(p, B, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
