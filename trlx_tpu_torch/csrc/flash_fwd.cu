// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax state,
// in two routes chosen by the wrapper from the shape (forward_route):
// - the short route, T, S <= 128: flash_fwd_short_kernel, one CTA per
//   (b, h) (its note is at the kernel, below the long route);
// - the long route, any T and S: flash_fwd_kernel, just below.
//
// Replaces: trlx_tpu/ops/flash_attention.py : _flash_forward / _flash_kernel
// (the forward of `flash_attention`, GQA routing of `_kv_head_index`).
//
// Computes, for q [B,H,T,D], k/v [B,Hkv,S,D] and key_mask [B,S]:
//   s[t,j] = (q[t] . k[j]) * sm_scale, replaced by -1e30 where the slot is
//            masked (key_mask == 0, or causal and q_offset + t < j),
//   m[t] = max_j s, l[t] = sum_j exp(s - m), out[t] = sum_j exp(s - m) v[j] / max(l, 1e-30)
// over the S real slots. A fully masked row therefore averages v uniformly
// over all S slots (every s = m = -1e30), as the TPU kernel does. Slots past
// the end of S (the ragged last tile) take no weight at all.
//
// What bounds it on this card: at the rollout's shapes (D = 64, T and S of a
// few hundred) each (b, h) pair does 4*T*S*D flops over 2*(T+S)*D*2 bytes, far
// below the H100's ~295 flop/byte ridge, so it is bound by the bytes of q, k,
// v and out. The design reads each of them once per CTA from device memory:
// one CTA per (b*h, 64-row query tile) keeps its 64 query rows in registers
// as mma fragments, streams K/V in 64-slot tiles through shared memory and
// keeps the online-softmax state (m, l, o) in fp32 registers, so the
// [T, S] score matrix never reaches device memory. Both products run on the
// tensor cores with mma.sync m16n8k16 (bf16 in, fp32 accumulate). GQA reads
// kv head h / (H / Hkv) in place, without repeating it. Tiles wholly in every
// row's causal future are skipped unless a row of the CTA has seen no
// attendable slot yet (that row's uniform average needs their V); K rows of
// masked or causal-future slots are never read.
// Head widths: D = 64 (GPT-2, T5) and D = 128 (the Llama family). At 128 the
// query fragments and the output accumulator double (32 + 64 fp32 registers
// a thread), so the D = 128 instantiation is bounded at two CTAs an SM (255
// registers a thread) instead of four.
// A faster version (TMA, wgmma, warp specialisation) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;         // query rows per CTA: 4 warps x 16 rows
constexpr int BK = 64;         // key slots per shared-memory tile
constexpr int NTHREADS = 128;
constexpr float NEG_INF = -1e30f;
__device__ __forceinline__ float neg_infinity() { return -__int_as_float(0x7f800000); }

// At most 128 registers a thread at D = 64, so that four CTAs share an SM:
// the teacher-forced pass launches B*H*ceil(T/64) CTAs, several waves of
// them. At D = 128, 255 (two CTAs an SM).
template <int D>
__global__ void __launch_bounds__(NTHREADS, D == 64 ? 4 : 2)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ key_mask,
                 __nv_bfloat16* __restrict__ out,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 int H, int Hkv, int T, int S,
                 long long q_sb, long long q_sh, long long q_st,
                 long long k_sb, long long k_sh, long long k_ss,
                 long long v_sb, long long v_sh, long long v_ss,
                 long long o_sb, long long o_sh, long long o_st,
                 int causal, int q_offset, float sm_scale) {
  constexpr int KSTEPS = D / 16;  // k-steps of Q K^T over the head dim
  constexpr int NT_S = BK / 8;    // 8-slot column tiles of the score tile
  constexpr int NT_O = D / 8;     // 8-channel column tiles of the output
  constexpr int LDS = D + 8;      // padded shared row, in bf16 elements

  __shared__ __align__(16) __nv_bfloat16 k_s[BK * LDS];
  __shared__ __align__(16) __nv_bfloat16 v_s[BK * LDS];
  __shared__ int valid_s[BK];  // 1 attendable, 0 masked, -1 past the end of S

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.y * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + hk * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + hk * v_sh;
  const int* mb = key_mask + (long long)b * S;

  // this warp's 16 query rows as A fragments, zero past the end of T
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = r0 + (r & 1) * 8;
      const int col = kk * 16 + c * 2 + (r >> 1) * 8;
      qf[kk][r] = row < T
          ? *reinterpret_cast<const uint32_t*>(qb + row * q_st + col)
          : 0u;
    }
  }

  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};
  float o_acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[n][e] = 0.f;

  const int row_last = min(q0 + BQ, T) - 1;
  const int n_tiles = (S + BK - 1) / BK;
  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * BK;
    if (causal && kv0 > q_offset + row_last) {
      // every slot from here on lies in every row's causal future: it adds
      // exp(-1e30 - m) = 0 to a row that has seen an attendable slot, so
      // stop unless some row has not (its uniform average needs all S)
      const int need = (r0 < T && m_run[0] == NEG_INF) ||
                       (r0 + 8 < T && m_run[1] == NEG_INF);
      if (!__syncthreads_or(need)) break;
    }
    __syncthreads();  // the previous tile is consumed
    constexpr int VECS = D / 8;  // 16-byte vectors per row
    for (int i = threadIdx.x; i < BK * VECS; i += NTHREADS) {
      const int row = i / VECS, col = (i % VECS) * 8;
      const int slot = kv0 + row;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (slot < S) {
        // a slot that is masked, or in every row's causal future, scores
        // -1e30 whatever its K: its K row is not read (V still is, for the
        // uniform average of a fully masked row)
        if (mb[slot] > 0 && !(causal && slot > q_offset + row_last)) {
          kx = *reinterpret_cast<const uint4*>(kb + slot * k_ss + col);
        }
        vx = *reinterpret_cast<const uint4*>(vb + slot * v_ss + col);
      }
      *reinterpret_cast<uint4*>(&k_s[row * LDS + col]) = kx;
      *reinterpret_cast<uint4*>(&v_s[row * LDS + col]) = vx;
    }
    if (threadIdx.x < BK) {
      const int slot = kv0 + threadIdx.x;
      valid_s[threadIdx.x] = slot < S ? (mb[slot] > 0 ? 1 : 0) : -1;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 slots
    float s[NT_S][4];
#pragma unroll
    for (int n = 0; n < NT_S; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
        const __nv_bfloat16* kr = &k_s[(n * 8 + g) * LDS + kk * 16 + c * 2];
        mma_bf16(s[n], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // scale, mask, and the tile's row maxima
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + c * 2 + (e & 1);
        const int row = r0 + (e >> 1) * 8;
        const int flag = valid_s[col];
        float x;
        if (flag < 0) {
          x = neg_infinity();  // past the end of S: no weight
        } else if (flag == 0 || (causal && q_offset + row < kv0 + col)) {
          x = NEG_INF;
        } else {
          x = s[n][e] * sm_scale;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      corr[i] = __expf(m_run[i] - m_new);
      m_run[i] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[n][e] - m_run[e >> 1]);
        s[n][e] = p;
        sum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l_run[i] = l_run[i] * corr[i] + sum[i];
    }
#pragma unroll
    for (int n = 0; n < NT_O; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o_acc[n][e] *= corr[e >> 1];

    // O += P V: the score accumulators of column tiles 2kk and 2kk+1 are
    // exactly the A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_f32(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_f32(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        const __nv_bfloat16* vr = &v_s[(kk * 16 + c * 2) * LDS + n * 8 + g];
        mma_bf16(o_acc[n], a, pack_bf16(vr[0], vr[LDS]),
                 pack_bf16(vr[8 * LDS], vr[9 * LDS]));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + i * 8;
    if (row >= T) continue;
    const float denom = fmaxf(l_run[i], 1e-30f);
    __nv_bfloat16* orow = out + b * o_sb + h * o_sh + row * o_st;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8 + c * 2) =
          pack_f32(o_acc[n][2 * i] / denom, o_acc[n][2 * i + 1] / denom);
    }
    if (c == 0) {
      m_out[(long long)bh * T + row] = m_run[i];
      l_out[(long long)bh * T + row] = l_run[i];
    }
  }
}

template <int D>
void launch(const void* q, const void* k, const void* v, const int* key_mask,
            void* out, float* m, float* l, int B, int H, int Hkv, int T, int S,
            const long long* st, int causal, int q_offset, float sm_scale,
            cudaStream_t stream) {
  const dim3 grid(B * H, (T + BQ - 1) / BQ);
  flash_fwd_kernel<D><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), key_mask,
      static_cast<__nv_bfloat16*>(out), m, l, H, Hkv, T, S,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], causal, q_offset, sm_scale);
}

}  // namespace

// strides: 12 element strides (b, h, t|s) of q, k, v, out, in that order;
// the last dimension of each is contiguous. Built for D = 64 (GPT-2's and
// T5's head width) and D = 128 (the Llama family's). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for another D.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              const int* key_mask, void* out, float* m, float* l,
                              int B, int H, int Hkv, int T, int S, int D,
                              const long long* strides, int causal, int q_offset,
                              float sm_scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    launch<64>(q, k, v, key_mask, out, m, l, B, H, Hkv, T, S, strides, causal, q_offset, sm_scale, st);
  } else if (D == 128) {
    launch<128>(q, k, v, key_mask, out, m, l, B, H, Hkv, T, S, strides, causal, q_offset, sm_scale, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// ---------------------------------------------------------------------------
// The short route, T, S <= 128: flash_fwd_short_kernel
// ---------------------------------------------------------------------------
//
// Replaces the same TPU kernel (_flash_kernel, trlx_tpu/ops/flash_attention.py:84)
// at the lengths every path of the port runs: the rollout prefill (T = 32 over
// a 128-slot cache), the teacher-forced passes and train steps (T = S = 64 and
// 72) and T5's cross-attention (T = 65 over S = 32). Same arguments, outputs
// and semantics as flash_fwd_kernel (the header at the top of this file).
//
// What bounds it: bytes, as above (at B64 H12 T = S = 72 some 27 MB of q, the
// needed k/v, out, m and l against ~2 flops a byte). The TPU kernel takes a
// head's whole K/V as one block (pl.BlockSpec((1, S, D), kv_ix)), and so does
// this one. What the long route pays at these lengths, and what this design
// does about it:
// 1. Dead query tiles. Its 64-row tiles leave the second CTA of a head with 8
//    live rows of 64 at T = 72 (one at T = 65), while its warps run every
//    product on rows past T. Here one CTA per (b, h) covers all T rows in
//    16-row strips, a warp a strip (up to six without causality). A causal
//    strip's walk grows with its index, so past four strips W = ceil(n/2)
//    warps pair them: warp w takes strips n-1-w and n-2W+w, the warp with
//    the longest walk has one strip and the others two of about the same
//    total walk. Fewer warps a CTA let more CTAs share an SM (T = 72: three
//    warps, not five; see the register bounds at the kernel).
// 2. K and V read twice per head, once by each query tile: here once per CTA.
// 3. Loads in series, under branches, through registers. Here the mask row
//    (at most 128 ints) is read first, by unconditional loads at clamped
//    addresses, and Q goes to shared memory by cp.async while it arrives.
//    Every warp folds the mask into words of attendable bits by a ballot (no
//    barrier), which also give the first attendable slot. Then one cp.async
//    burst brings K and V of exactly the slots the head needs, zero-filled
//    (nothing read) elsewhere: K of the attendable slots before the last one
//    some row's causal window reaches; V of the same slots, or of every slot
//    of S when a row is fully masked (causal row t is, exactly when q_offset
//    + t < the first attendable slot; its output is V's uniform average over
//    S). This is what chip_smoke.py's flash_work counts as the bound's bytes.
//    Q and K close the first group of copies and V the second: the strips
//    compute their scores while V still arrives.
// 4. Online rescaling over 64-slot tiles. Here a strip keeps its whole row of
//    scores (at most 128 slots, 64 fp32 registers a thread) in registers: one
//    row max, one exp, the row sum, then P V on the tensor cores (p packed
//    to bf16 first, and the output in chunks of 32 channels of the head
//    dim, two at D = 64 and four at D = 128, to save registers: the
//    registers of a strip do not grow with D). Causal skipping is per 16-slot block: a block in the causal
//    future of every row of a strip takes no S product, no softmax and,
//    unless the strip holds a fully masked row, no P V product. An 8-slot
//    tile whose every pair is weighed takes the scale alone (no per-pair
//    mask). The output leaves through shared memory, 16 bytes a lane.
// Masked slots score -1e30 and slots past S take no weight, exactly as in
// flash_fwd_kernel, so m and l keep their meaning for the backward kernels.
// GQA reads kv head h / (H / Hkv) in place; nothing is summed across CTAs.
// At D = 128 (the Llama family) the same design holds T, S <= 128: Q, K and V
// rows double to 272 bytes (104 KB of shared memory at T = S = 128), the Q K^T
// product takes eight k-steps instead of four, and the registers stay those
// of D = 64; each instantiation is bounded at two CTAs an SM.
// TMA, wgmma and a persistent grid are later work.

namespace {

typedef __nv_bfloat16 bf16;

constexpr int SHORT_MAX = 128;  // the longest T or S the short kernel takes
constexpr int OCH = 4;          // 8-channel output tiles a P V chunk (32 channels)

// padded Q / K / V row in shared memory, bf16 elements
__host__ __device__ constexpr int short_lds(int D) { return D + 8; }

// warps of a short-route CTA for n_strips = ceil(T / 16), at most six: one
// a strip up to four strips, or up to six without causality (every strip
// then walks all of S); past that ceil(n_strips / 2) warps take the strips
// in pairs, which for causal strips (whose walks grow with their index) are
// of about equal total walk
__host__ __device__ constexpr int short_warps(int n_strips, int causal) {
  return n_strips <= 4 || (!causal && n_strips <= 6) ? n_strips : (n_strips + 1) / 2;
}

// the end (exclusive) of the slots some row's causal window reaches; past it
// every slot is in every row's causal future
__host__ __device__ inline int short_kv_end(int T, int S, int causal, int q_offset) {
  if (!causal) return S;
  const int end = q_offset + T < 0 ? 0 : q_offset + T;
  return end < S ? end : S;
}

// dynamic shared memory: q [tp][D + 8], k [kp][D + 8], v [sp][D + 8] (bf16)
inline int short_smem_bytes(int D, int tp, int kp, int sp) { return 2 * (tp + kp + sp) * short_lds(D); }

// One CTA per (b, h) of short_warps(ceil(T / 16), causal) warps; NK =
// ceil16(S) / 16 sizes the strips' score registers. KP =
// ceil16(short_kv_end(...)) is the number of K rows in shared memory.
// Registers are bounded per instantiation so that a B64 x H12 pass's 768
// CTAs run in one wave, six an SM (each of an SM's four register banks of
// 16K holds a quarter of its warps): up to S = 64 at most 80 a thread (six
// four-warp CTAs at T = 64); up to S = 80 about 100, of which six
// three-warp CTAs at T = 72 need 96 or fewer (the build gives 94); past
// that 128 (eight two-warp CTAs at the prefill's T = 32 over S = 128). At
// D = 128 two CTAs an SM (170 registers up to S = 80, 128 past that).
template <int NK, int D>
__global__ void __launch_bounds__(NK <= 5 ? 192 : 256, D == 64 ? (NK <= 4 ? 4 : (NK == 5 ? 3 : 2)) : 2)
flash_fwd_short_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const int* __restrict__ key_mask,
                       bf16* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out,
                       int H, int Hkv, int T, int S, int KP,
                       long long q_sb, long long q_sh, long long q_st,
                       long long k_sb, long long k_sh, long long k_ss,
                       long long v_sb, long long v_sh, long long v_ss,
                       long long o_sb, long long o_sh, long long o_st,
                       int causal, int q_offset, float sm_scale) {
  constexpr int KSTEPS = D / 16;  // k-steps of Q K^T over the head dim
  constexpr int NT_O = D / 8;     // 8-channel tiles of the output
  constexpr int LDS = short_lds(D);
  constexpr int SP = NK * 16;
  constexpr int NT_S = 2 * NK;       // 8-slot tiles of a strip's row
  constexpr int NW = (NK + 1) / 2;   // words of attendable bits
  constexpr int VECS = D / 8;        // 16-byte vectors a row

  extern __shared__ __align__(16) unsigned char smem[];
  const int TP = (T + 15) & ~15;
  const int n_strips = TP / 16;
  const int W = short_warps(n_strips, causal);
  const int nthreads = 32 * W;
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + TP * LDS;
  bf16* v_s = k_s + KP * LDS;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + hk * k_sh;
  const bf16* vb = v + b * v_sb + hk * v_sh;
  const int* mb = key_mask + (long long)b * S;
  const int kv_end = short_kv_end(T, S, causal, q_offset);

  // 1. the mask row (at most 128 ints; every warp reads it, so its bits
  // come by a ballot with no barrier), then Q by cp.async (zero-filled past
  // T) while the mask arrives
  int mk[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) mk[w] = __ldg(mb + min(w * 32 + lane, S - 1));
  for (int i = tid; i < TP * VECS; i += nthreads) {
    const int row = i / VECS, col = (i % VECS) * 8;
    const bool ok = row < T;
    cp_async16(&q_s[row * LDS + col], qb + (ok ? row * q_st + col : 0), ok);
  }
  unsigned bits[NW];  // bit r of word w: slot 32 w + r is attendable
  int first = S;      // the first attendable slot (S: none)
#pragma unroll
  for (int w = NW - 1; w >= 0; --w) {
    bits[w] = __ballot_sync(0xffffffffu, w * 32 + lane < S && mk[w] > 0);
    if (bits[w] != 0u) first = w * 32 + __ffs(bits[w]) - 1;
  }
  // rows fully masked (every score -1e30) are the first ones: row t is when
  // no slot is attendable, or when causal and q_offset + t < first
  const bool any_dead = first >= S || (causal && q_offset < first);

  // 2. K of the attendable slots before kv_end; V of the same slots, or of
  // every slot of S when a row is fully masked; zero-filled elsewhere. Word
  // by word, so that each row's bit is a register's.
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    for (int i = tid; i < min(32, KP - w * 32) * VECS; i += nthreads) {
      const int r = i / VECS, row = w * 32 + r, col = (i % VECS) * 8;
      const bool ok = row < kv_end && ((bits[w] >> r) & 1u);
      cp_async16(&k_s[row * LDS + col], kb + (ok ? row * k_ss + col : 0), ok);
    }
  }
  cp_async_commit();  // Q and K
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    for (int i = tid; i < min(32, SP - w * 32) * VECS; i += nthreads) {
      const int r = i / VECS, row = w * 32 + r, col = (i % VECS) * 8;
      const bool ok = any_dead ? row < S : row < kv_end && ((bits[w] >> r) & 1u);
      cp_async16(&v_s[row * LDS + col], vb + (ok ? row * v_ss + col : 0), ok);
    }
  }
  cp_async_commit();  // V
  cp_async_wait_group<1>();
  __syncthreads();  // Q and K are in shared memory

  // 3. the strips: warp w takes strip n-1-w, then strip n-2W+w where it exists
  for (int pass = 0; pass < 2; ++pass) {
    const int st = pass == 0 ? n_strips - 1 - warp : n_strips - 2 * W + warp;
    if (st < 0) continue;
    const int r_base = st * 16;
    const int r0 = r_base + g;  // this thread's rows: r0 and r0 + 8
    // 16-slot blocks from nb on lie in the causal future of every row of the
    // strip (nb * 16 <= KP); a strip that holds a fully masked row (then its
    // first row is) weighs V over all of S
    int nb = NK;
    if (causal) {
      const int lim = q_offset + min(r_base + 15, T - 1);
      nb = lim < 0 ? 0 : min(lim / 16 + 1, NK);
    }
    const bool dead = first >= S || (causal && q_offset + r_base < first);
    const int nb_pv = dead ? NK : nb;

    // S = Q K^T over the strip's live blocks
    float s[NT_S][4];
#pragma unroll
    for (int n = 0; n < NT_S; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t qa[4];
      ldm_a<LDS>(qa, q_s, r_base, kk, lane);
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        if (j < nb) {
          uint32_t kf[4];
          ldm_b_cols<LDS>(kf, k_s, kk, 2 * j, lane);
          mma_bf16(s[2 * j], qa, kf[0], kf[1]);
          mma_bf16(s[2 * j + 1], qa, kf[2], kf[3]);
        }
      }
    }

    // scale and mask the whole row, its max, exp and sum. Tiles from n_tiles
    // on add p = 0 to every row of a strip without a fully masked row, and
    // are left out. A tile whose every pair is weighed (all its slots
    // attendable and inside the strip's first row's causal window) takes
    // the scale alone; the others are masked pair by pair. Both tests are
    // the same on every lane.
    const int n_tiles = dead ? NT_S : 2 * nb;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
      if (n >= n_tiles) continue;
      const unsigned byte = (bits[n >> 2] >> ((n & 3) * 8)) & 0xffu;
      if (byte == 0xffu && (!causal || n * 8 + 7 <= q_offset + r_base)) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] *= sm_scale;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
        continue;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + c * 2 + (e & 1);
        const int row = r0 + (e >> 1) * 8;
        const bool att = (byte >> (c * 2 + (e & 1))) & 1u;
        float x;
        if (col >= S) {
          x = neg_infinity();  // past the end of S: no weight
        } else if (!att || (causal && q_offset + row < col)) {
          x = NEG_INF;
        } else {
          x = s[n][e] * sm_scale;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // the row's 4 lanes hold 2 columns a tile each
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
      if (n >= n_tiles) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[n][e] - mx[e >> 1]);
        s[n][e] = p;
        sum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      const int row = r0 + i * 8;
      if (c == 0 && row < T) {
        m_out[(long long)bh * T + row] = mx[i];
        l_out[(long long)bh * T + row] = sum[i];
      }
    }
    // p in bf16 as the A fragments of P V: the accumulators of 8-slot tiles
    // 2j and 2j + 1 are the A fragment of 16-slot block j (half the
    // registers of the fp32 row)
    uint32_t pa[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      if (j < nb_pv) pack_acc(pa[j], s[2 * j], s[2 * j + 1]);
    }
    if (pass == 0) {  // every warp has a first strip
      cp_async_wait_all();
      __syncthreads();  // V is in shared memory
    }

    // 4. O = P V, 32 channels of the head dim at a time (16 accumulators a
    // thread), each chunk through the strip's own Q rows in shared memory
    // (no other warp reads them) on its way to device memory
    const float inv[2] = {1.f / fmaxf(sum[0], 1e-30f), 1.f / fmaxf(sum[1], 1e-30f)};
    bf16* o_s = q_s + r_base * LDS;
    __syncwarp();  // the strip's Q fragments are read
#pragma unroll
    for (int half = 0; half < NT_O / OCH; ++half) {
      float o[OCH][4];
#pragma unroll
      for (int n = 0; n < OCH; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        if (j < nb_pv) {
#pragma unroll
          for (int n = 0; n < OCH; n += 2) {
            uint32_t vf[4];
            ldm_b_rows<LDS>(vf, v_s, j, half * OCH + n, lane);
            mma_bf16(o[n], pa[j], vf[0], vf[1]);
            mma_bf16(o[n + 1], pa[j], vf[2], vf[3]);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < OCH; ++n) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          *reinterpret_cast<uint32_t*>(&o_s[(g + i * 8) * LDS + (half * OCH + n) * 8 + c * 2]) =
              pack_f32(o[n][2 * i] * inv[i], o[n][2 * i + 1] * inv[i]);
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int x = lane; x < 16 * VECS; x += 32) {
      const int row = x / VECS, col = (x % VECS) * 8;
      if (r_base + row < T) {
        *reinterpret_cast<uint4*>(out + b * o_sb + h * o_sh + (r_base + row) * o_st + col) =
            *reinterpret_cast<const uint4*>(&o_s[row * LDS + col]);
      }
    }
  }
}

// sets the kernel's dynamic shared memory limit (its 128-row footprint) once
// per device; returns a CUDA error code
template <int NK, int D>
int short_prepare() {
  static unsigned long long done = 0;  // one bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && (done >> dev & 1ULL)) return 0;
  err = cudaFuncSetAttribute(flash_fwd_short_kernel<NK, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             short_smem_bytes(D, SHORT_MAX, NK * 16, NK * 16));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64) done |= 1ULL << dev;
  return 0;
}

// (threads, dynamic shared memory, K rows in shared memory) of a launch at
// these lengths
inline void short_config(int D, int T, int S, int causal, int q_offset, int* threads, int* smem_bytes,
                         int* kp) {
  const int tp = (T + 15) & ~15;
  *kp = (short_kv_end(T, S, causal, q_offset) + 15) & ~15;
  *threads = 32 * short_warps(tp / 16, causal);
  *smem_bytes = short_smem_bytes(D, tp, *kp, (S + 15) & ~15);
}

template <int NK, int D>
int short_launch(const void* q, const void* k, const void* v, const int* key_mask, void* out, float* m,
                 float* l, int B, int H, int Hkv, int T, int S, const long long* st, int causal, int q_offset,
                 float sm_scale, cudaStream_t stream) {
  const int rc = short_prepare<NK, D>();
  if (rc != 0) return rc;
  int threads = 0, smem_bytes = 0, kp = 0;
  short_config(D, T, S, causal, q_offset, &threads, &smem_bytes, &kp);
  flash_fwd_short_kernel<NK, D><<<B * H, threads, smem_bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), key_mask,
      static_cast<bf16*>(out), m, l, H, Hkv, T, S, kp, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], causal, q_offset, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int NK, int D>
int short_occupancy(int T, int S, int causal, int q_offset, int* ctas_per_sm, int* threads, int* smem_bytes) {
  const int rc = short_prepare<NK, D>();
  if (rc != 0) return rc;
  int kp = 0;
  short_config(D, T, S, causal, q_offset, threads, smem_bytes, &kp);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, flash_fwd_short_kernel<NK, D>, *threads, *smem_bytes));
}

// f(std::integral_constant<int, NK>) for NK = ceil16(S) / 16 in 1..8
template <typename F>
int by_nk(int S, F&& f) {
  switch ((S + 15) / 16) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The short route, T, S <= 128 and D in {64, 128}: the arguments and outputs
// of flash_fwd_bf16. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for another D or a longer T or S.
extern "C" int flash_fwd_short_bf16(const void* q, const void* k, const void* v, const int* key_mask,
                                    void* out, float* m, float* l, int B, int H, int Hkv, int T, int S, int D,
                                    const long long* strides, int causal, int q_offset, float sm_scale,
                                    void* stream) {
  if ((D != 64 && D != 128) || T < 1 || S < 1 || T > SHORT_MAX || S > SHORT_MAX || Hkv < 1 || H % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_nk(S, [&](auto nk) {
    constexpr int NK = decltype(nk)::value;
    return D == 64
        ? short_launch<NK, 64>(q, k, v, key_mask, out, m, l, B, H, Hkv, T, S, strides, causal, q_offset, sm_scale, s)
        : short_launch<NK, 128>(q, k, v, key_mask, out, m, l, B, H, Hkv, T, S, strides, causal, q_offset, sm_scale, s);
  });
}

// What a short-route launch at these lengths and head width gets: its
// threads, its dynamic shared memory and the CTAs an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int flash_fwd_short_occupancy(int T, int S, int D, int causal, int q_offset, int* ctas_per_sm,
                                         int* threads, int* smem_bytes) {
  if ((D != 64 && D != 128) || T < 1 || S < 1 || T > SHORT_MAX || S > SHORT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  return by_nk(S, [&](auto nk) {
    constexpr int NK = decltype(nk)::value;
    return D == 64 ? short_occupancy<NK, 64>(T, S, causal, q_offset, ctas_per_sm, threads, smem_bytes)
                   : short_occupancy<NK, 128>(T, S, causal, q_offset, ctas_per_sm, threads, smem_bytes);
  });
}
