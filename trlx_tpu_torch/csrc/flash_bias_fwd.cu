// Bias-carrying flash-attention forward for Hopper (sm_90a), bf16 in, fp32
// softmax state: T5's self-attention with its learned relative position bias.
// Two routes, chosen by the wrapper from the shape (bias_forward_route):
// - the short route, T, S <= 128: flash_bias_fwd_short_kernel, one CTA per
//   (b, h) (its note is at the kernel, below the long route);
// - the long route, any T and S: flash_bias_fwd_kernel, just below.
//
// Replaces: trlx_tpu/ops/flash_attention.py : _flash_bias_forward /
// _flash_bias_kernel (the forward of `flash_attention_bias`).
//
// Computes, for q [B,H,T,D], k/v [B,H,S,D] (no GQA), key_mask [B,S] and the
// batch-invariant fp32 bias [H,T,S]:
//   s[t,j] = (q[t] . k[j]) * sm_scale + bias[h,t,j], replaced by -1e30 where
//            the slot is masked (key_mask == 0, or causal and t < j: the
//            causal rule is top-left, row >= column, with no query offset),
//   m[t] = max_j s, l[t] = sum_j exp(s - m), out[t] = sum_j exp(s - m) v[j] / max(l, 1e-30)
// over the S real slots. A fully masked row averages v uniformly over all S
// slots (every s = m = -1e30, the bias is not added there), as the TPU kernel
// does. Slots past the end of S (the ragged last tile) take no weight.
//
// What bounds it on this card: per (b, h) pair the function does 4*T*S*D
// flops over 2*(T+S)*D*2 bytes of q, k, v, out plus the bias, 4*T*S bytes
// per head but shared by the B batch rows. At T5's shapes (D = 64, T and S of
// 32 to a few hundred) that is far below the H100's ~295 flop/byte ridge, so
// the function is bound by its bytes, and at these sizes in practice by
// latency (B*H*ceil(T/64) CTAs, one or two waves). The design is the plain
// flash forward's (csrc/flash_fwd.cu): one CTA per (b*h, 64-row query tile)
// keeps its query rows in registers as mma fragments, streams K/V in 64-slot
// tiles through shared memory and keeps (m, l, o) in fp32 registers, so no
// [T, S] tile reaches device memory. The bias is read straight from device
// memory in the score fragments' layout: the four lanes of a fragment row
// read 8 neighbouring floats of one bias row, a whole 32-byte sector, and
// the B CTAs of a head read the same tile, which the 50 MB L2 serves after
// the first. Both products run on mma.sync m16n8k16 (bf16 in, fp32
// accumulate). Tiles wholly in every row's causal future are skipped unless
// a row of the CTA has seen no attendable slot yet; K rows of masked or
// causal-future slots are never read. TMA, wgmma and pipelining are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;         // query rows per CTA: 4 warps x 16 rows
constexpr int BK = 64;         // key slots per shared-memory tile
constexpr int NTHREADS = 128;
constexpr float NEG_INF = -1e30f;
__device__ __forceinline__ float neg_infinity() { return -__int_as_float(0x7f800000); }

template <int D>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_bias_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const int* __restrict__ key_mask,
                      const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ m_out, float* __restrict__ l_out,
                      int H, int T, int S,
                      long long q_sb, long long q_sh, long long q_st,
                      long long k_sb, long long k_sh, long long k_ss,
                      long long v_sb, long long v_sh, long long v_ss,
                      long long o_sb, long long o_sh, long long o_st,
                      int causal, float sm_scale) {
  constexpr int KSTEPS = D / 16;  // k-steps of Q K^T over the head dim
  constexpr int NT_S = BK / 8;    // 8-slot column tiles of the score tile
  constexpr int NT_O = D / 8;     // 8-channel column tiles of the output
  constexpr int LDS = D + 8;      // padded shared row, in bf16 elements

  __shared__ __align__(16) __nv_bfloat16 k_s[BK * LDS];
  __shared__ __align__(16) __nv_bfloat16 v_s[BK * LDS];
  __shared__ int valid_s[BK];  // 1 attendable, 0 masked, -1 past the end of S

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  const int* mb = key_mask + (long long)b * S;
  const float* biasb = bias + (long long)h * T * S;

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
    if (causal && kv0 > row_last) {
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
        // a masked or causal-future slot scores -1e30 whatever its K: its K
        // row is not read (V still is, for a fully masked row's average)
        if (mb[slot] > 0 && !(causal && slot > row_last)) {
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

    // scale, add the bias, mask, and the tile's row maxima
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
        } else if (flag == 0 || (causal && row < kv0 + col) || row >= T) {
          x = NEG_INF;
        } else {
          x = s[n][e] * sm_scale + biasb[(long long)row * S + kv0 + col];
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

typedef __nv_bfloat16 bf16;

}  // namespace

// strides: 12 element strides (b, h, t|s) of q, k, v, out, in that order; the
// last dimension of each is contiguous. bias is a contiguous fp32 [H, T, S];
// m, l are contiguous fp32 [B*H, T]. Built for D = 64 (T5's d_kv); another
// width is instantiated with the model that needs it. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for another D.
extern "C" int flash_bias_fwd_bf16(const void* q, const void* k, const void* v,
                                   const int* key_mask, const float* bias, void* out,
                                   float* m, float* l, int B, int H, int T, int S, int D,
                                   const long long* st, int causal, float sm_scale,
                                   void* stream) {
  if (D != 64) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B * H, (T + BQ - 1) / BQ);
  flash_bias_fwd_kernel<64><<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      key_mask, bias, static_cast<bf16*>(out), m, l, H, T, S,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_bias_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// ---------------------------------------------------------------------------
// The short route, T, S <= 128: flash_bias_fwd_short_kernel
// ---------------------------------------------------------------------------
//
// Replaces the same TPU kernel (_flash_bias_kernel,
// trlx_tpu/ops/flash_attention.py:452) at the lengths T5's paths run: the
// encoder's self-attention (T = S = 32, not causal) and the decoder's (T = S
// = 65, causal). Same arguments, outputs and semantics as
// flash_bias_fwd_kernel (the header at the top of this file).
//
// What bounds it: bytes, as above (at B12 H12 T = S = 65 some 4.5 MB of q,
// the needed k/v, out, m, l and the bias against ~2 flops a byte), and at
// these sizes the latency of each dependent round trip to device memory.
// What the long route pays here, and what this design does about it:
// 1. Dead query tiles. Its 64-row tiles leave the second CTA of a head one
//    live row of 64 at T = 65, which still runs every product and reads the
//    head's K/V again. Here one CTA per (b, h) covers all T rows in 16-row
//    strips, one warp a strip. At these sizes a launch takes about as long
//    as one CTA's critical path (the decoder's B12 H12 launch 0.0122 ms on
//    an H100, one CTA alone 0.0101), so the strips are not paired onto
//    fewer warps as flash_fwd_short_kernel pairs causal ones: pairing the
//    decoder's five strips onto three warps took 0.0155 ms
//    (tools/bwd_stages.py --kernel bias_fwd, `paired_strips`; PERF.md).
// 2. Loads in series, under branches, through registers. Here the mask row
//    (at most 128 ints) is read first, by unconditional loads at clamped
//    addresses, and cp.async copies of Q and the head's whole bias tile
//    [T, S], which need no mask, are issued while it arrives. Every warp
//    folds the mask into words of attendable bits by a ballot (no barrier),
//    which also give the first attendable slot. Then, zero-filled (nothing
//    read) where not needed, K of the attendable slots closes group 1 (a
//    causal call has T == S, so the last row's window reaches every slot),
//    and V of the same slots, or of every slot of S when a row is fully
//    masked, is group 2: the strips score while V arrives.
// 3. The bias read from device memory after the QK product. Here the head's
//    tile is in shared memory before any score is taken. A bias row of S
//    floats is 4 S bytes and the head's tile starts at 4 h T S bytes, which
//    are not 16-byte aligned at S = 65, so the tile is copied as one flat
//    range: 4-byte copies up to the first 16-byte boundary and past the
//    last, 16-byte copies between, into shared memory at the same offset
//    modulo 16 bytes (tile entry i at b_s[mis + i]). The B CTAs of a head
//    read the same tile, which the L2 serves after the first.
// 4. Online rescaling over 64-slot tiles, two barriers a tile. Here a strip
//    keeps its whole row of scores (at most 128 slots) in registers: one row
//    max, one exp, the row sum, then P V on the tensor cores (mma.sync
//    m16n8k16, p packed to bf16, the output in two halves of the head dim).
//    Causal skipping is per 16-slot block. The output leaves through shared
//    memory, 16 bytes a lane.
// Masked slots score -1e30 without the bias, so a row that attends no slot
// has every score -1e30, m = -1e30 and l = S exactly; slots past S take no
// weight (-inf). m and l keep their meaning for the backward kernels
// (csrc/flash_bias_bwd.cu), which read them. A persistent grid, TMA and
// wgmma are later work.

namespace {

constexpr int SHORT_MAX = 128;     // the longest T or S the short kernel takes
constexpr int SHORT_LDS = 64 + 8;  // padded Q / K / V row in shared memory, bf16 elements (D = 64)

// fp32 entries of the bias tile in shared memory: T S, after up to three
// entries of alignment, rounded up to whole 16-byte vectors
__host__ __device__ inline int short_bias_floats(int T, int S) { return (T * S + 6) & ~3; }

// dynamic shared memory: q [ceil16(T)][72], k and v [ceil16(S)][72]
// (bf16), then the bias tile (fp32)
inline int short_smem_bytes(int T, int S) {
  return 2 * (((T + 15) & ~15) + 2 * ((S + 15) & ~15)) * SHORT_LDS + 4 * short_bias_floats(T, S);
}

// One CTA per (b, h) of ceil(T / 16) warps, one a 16-row strip, at most
// 256 threads; NK = ceil16(S) / 16 sizes the strips' score registers.
// Registers are bounded to 128 a thread up to S = 80 (the decoder's 65:
// its five-warp CTAs are held to four an SM by their ~51 KB of shared
// memory) and 255 past that.
template <int NK>
__global__ void __launch_bounds__(256, NK <= 5 ? 2 : 1)
flash_bias_fwd_short_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const int* __restrict__ key_mask,
                            const float* __restrict__ bias, bf16* __restrict__ out,
                            float* __restrict__ m_out, float* __restrict__ l_out,
                            int H, int T, int S,
                            long long q_sb, long long q_sh, long long q_st,
                            long long k_sb, long long k_sh, long long k_ss,
                            long long v_sb, long long v_sh, long long v_ss,
                            long long o_sb, long long o_sh, long long o_st,
                            int causal, float sm_scale) {
  constexpr int D = 64;
  constexpr int KSTEPS = D / 16;  // k-steps of Q K^T over the head dim
  constexpr int NT_O = D / 8;     // 8-channel tiles of the output
  constexpr int LDS = SHORT_LDS;
  constexpr int SP = NK * 16;
  constexpr int NT_S = 2 * NK;     // 8-slot tiles of a strip's row
  constexpr int NW = (NK + 1) / 2;  // words of attendable bits
  constexpr int VECS = D / 8;      // 16-byte vectors a row

  extern __shared__ __align__(16) unsigned char smem[];
  const int TP = (T + 15) & ~15;
  const int nthreads = 2 * TP;  // a warp a 16-row strip
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + TP * LDS;
  bf16* v_s = k_s + SP * LDS;
  float* b_s = reinterpret_cast<float*>(v_s + SP * LDS);

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;
  const int* mb = key_mask + (long long)b * S;
  const float* bb = bias + (long long)h * T * S;

  // 1. the mask row, at clamped addresses (every warp reads it, so its bits
  // come by a ballot with no barrier)
  int mk[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) mk[w] = __ldg(mb + min(w * 32 + lane, S - 1));

  // 2. while it arrives: Q (zero-filled past T) and the head's bias tile as
  // one flat range, into group 1
  for (int i = tid; i < TP * VECS; i += nthreads) {
    const int row = i / VECS, col = (i % VECS) * 8;
    const bool ok = row < T;
    cp_async16(&q_s[row * LDS + col], qb + (ok ? row * q_st + col : 0), ok);
  }
  const int n_bias = T * S;
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(bb) >> 2) & 3u);  // entries past a 16-byte boundary
  const int head = min((4 - mis) & 3, n_bias);  // entries before the first boundary
  const int n_vec = (n_bias - head) >> 2;        // whole 16-byte vectors after it
  const int tail = head + 4 * n_vec;
  for (int i = tid; i < head + (n_bias - tail); i += nthreads) {
    const int e = i < head ? i : tail + i - head;
    cp_async4(&b_s[mis + e], bb + e, true);
  }
  for (int i = tid; i < n_vec; i += nthreads) cp_async16(&b_s[mis + head + 4 * i], bb + head + 4 * i, true);

  // 3. the ballot
  unsigned bits[NW];  // bit r of word w: slot 32 w + r is attendable
  int first = S;      // the first attendable slot (S: none)
#pragma unroll
  for (int w = NW - 1; w >= 0; --w) {
    bits[w] = __ballot_sync(0xffffffffu, w * 32 + lane < S && mk[w] > 0);
    if (bits[w] != 0u) first = w * 32 + __ffs(bits[w]) - 1;
  }
  // rows fully masked (every score -1e30) are the first ones: row t is when
  // no slot is attendable, or when causal and t < first
  const bool any_dead = first >= S || (causal && first > 0);

  // 4. K of the attendable slots, word by word (so that each row's bit is
  // a register's); group 1 closes
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    for (int i = tid; i < min(32, SP - w * 32) * VECS; i += nthreads) {
      const int r = i / VECS, row = w * 32 + r, col = (i % VECS) * 8;
      const bool ok = (bits[w] >> r) & 1u;
      cp_async16(&k_s[row * LDS + col], kb + (ok ? row * k_ss + col : 0), ok);
    }
  }
  cp_async_commit();  // Q, the bias and K

  // 5. V of the slots K was read for, or of every slot of S when a row is
  // fully masked (its output is V's uniform average over S): group 2
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    for (int i = tid; i < min(32, SP - w * 32) * VECS; i += nthreads) {
      const int r = i / VECS, row = w * 32 + r, col = (i % VECS) * 8;
      const bool ok = any_dead ? row < S : ((bits[w] >> r) & 1u) != 0u;
      cp_async16(&v_s[row * LDS + col], vb + (ok ? row * v_ss + col : 0), ok);
    }
  }
  cp_async_commit();  // V
  cp_async_wait_group<1>();
  __syncthreads();  // Q, K and the bias are in shared memory

  // 6. the strip of warp w: rows 16 w..
  const int r_base = warp * 16;
  const int r0 = r_base + g;  // this thread's rows: r0 and r0 + 8
  // 16-slot blocks from nb on lie in the causal future of every row of the
  // strip; a strip that holds a fully masked row (then its first row is)
  // weighs V over all of S
  const int nb = causal ? min(min(r_base + 15, T - 1) / 16 + 1, NK) : NK;
  const bool dead = first >= S || (causal && r_base < first);
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

  // scale, add the bias and mask the whole row; its max, exp and sum.
  // Tiles from n_tiles on add p = 0 to every row of a strip without a
  // fully masked row, and are left out. A tile whose every pair is weighed
  // (all its slots attendable and inside the strip's first row's causal
  // window) takes the scale and the bias alone; the others are masked pair
  // by pair, and a masked pair takes no bias. A row past T (the last
  // strip's padding) reads row T - 1's bias; its results are dropped.
  const int n_tiles = dead ? NT_S : 2 * nb;
  const float* brow[2] = {b_s + mis + min(r0, T - 1) * S, b_s + mis + min(r0 + 8, T - 1) * S};
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int n = 0; n < NT_S; ++n) {
    if (n >= n_tiles) continue;
    const unsigned byte = (bits[n >> 2] >> ((n & 3) * 8)) & 0xffu;
    if (byte == 0xffu && (!causal || n * 8 + 7 <= r_base)) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = s[n][e] * sm_scale + brow[e >> 1][n * 8 + c * 2 + (e & 1)];
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
      } else if (!att || (causal && row < col)) {
        x = NEG_INF;
      } else {
        x = s[n][e] * sm_scale + brow[e >> 1][col];
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
  // 2j and 2j + 1 are the A fragment of 16-slot block j
  uint32_t pa[NK][4];
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    if (j < nb_pv) pack_acc(pa[j], s[2 * j], s[2 * j + 1]);
  }
  cp_async_wait_all();
  __syncthreads();  // V is in shared memory (and every Q fragment read)

  // 7. O = P V, a half of the head dim at a time, each half through the
  // strip's own Q rows in shared memory (no other warp reads them) on its
  // way to device memory
  const float inv[2] = {1.f / fmaxf(sum[0], 1e-30f), 1.f / fmaxf(sum[1], 1e-30f)};
  bf16* o_s = q_s + r_base * LDS;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float o[NT_O / 2][4];
#pragma unroll
    for (int n = 0; n < NT_O / 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      if (j < nb_pv) {
#pragma unroll
        for (int n = 0; n < NT_O / 2; n += 2) {
          uint32_t vf[4];
          ldm_b_rows<LDS>(vf, v_s, j, half * (NT_O / 2) + n, lane);
          mma_bf16(o[n], pa[j], vf[0], vf[1]);
          mma_bf16(o[n + 1], pa[j], vf[2], vf[3]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NT_O / 2; ++n) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        *reinterpret_cast<uint32_t*>(&o_s[(g + i * 8) * LDS + (half * (NT_O / 2) + n) * 8 + c * 2]) =
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

// sets the kernel's dynamic shared memory limit (its footprint at T = 128
// and S = 16 NK) once per device; returns a CUDA error code
template <int NK>
int short_prepare() {
  static unsigned long long done = 0;  // one bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && (done >> dev & 1ULL)) return 0;
  err = cudaFuncSetAttribute(flash_bias_fwd_short_kernel<NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             short_smem_bytes(SHORT_MAX, NK * 16));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64) done |= 1ULL << dev;
  return 0;
}

// threads of a launch at these lengths: a warp a 16-row strip
inline int short_threads(int T) { return 2 * ((T + 15) & ~15); }

template <int NK>
int short_launch(const void* q, const void* k, const void* v, const int* key_mask, const float* bias, void* out,
                 float* m, float* l, int B, int H, int T, int S, const long long* st, int causal, float sm_scale,
                 cudaStream_t stream) {
  const int rc = short_prepare<NK>();
  if (rc != 0) return rc;
  flash_bias_fwd_short_kernel<NK><<<B * H, short_threads(T), short_smem_bytes(T, S), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), key_mask, bias,
      static_cast<bf16*>(out), m, l, H, T, S, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int NK>
int short_occupancy(int T, int S, int* ctas_per_sm, int* threads, int* smem_bytes) {
  const int rc = short_prepare<NK>();
  if (rc != 0) return rc;
  *threads = short_threads(T);
  *smem_bytes = short_smem_bytes(T, S);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, flash_bias_fwd_short_kernel<NK>, *threads, *smem_bytes));
}

inline bool short_takes(int T, int S, int causal) {
  return T >= 1 && S >= 1 && T <= SHORT_MAX && S <= SHORT_MAX && !(causal && T != S);
}

}  // namespace

// The short route, T, S <= 128 and D = 64 (T == S when causal): the
// arguments and outputs of flash_bias_fwd_bf16. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a shape it does not take.
extern "C" int flash_bias_fwd_short_bf16(const void* q, const void* k, const void* v, const int* key_mask,
                                         const float* bias, void* out, float* m, float* l, int B, int H, int T,
                                         int S, int D, const long long* strides, int causal, float sm_scale,
                                         void* stream) {
  if (D != 64 || !short_takes(T, S, causal)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((S + 15) / 16) {
#define SHORT_CASE(NK) \
  case NK:             \
    return short_launch<NK>(q, k, v, key_mask, bias, out, m, l, B, H, T, S, strides, causal, sm_scale, s);
    SHORT_CASE(1) SHORT_CASE(2) SHORT_CASE(3) SHORT_CASE(4)
    SHORT_CASE(5) SHORT_CASE(6) SHORT_CASE(7) SHORT_CASE(8)
#undef SHORT_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// What a short-route launch at these lengths gets: its threads, its dynamic
// shared memory and the CTAs an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int flash_bias_fwd_short_occupancy(int T, int S, int causal, int* ctas_per_sm, int* threads,
                                              int* smem_bytes) {
  if (!short_takes(T, S, causal)) return static_cast<int>(cudaErrorInvalidValue);
  switch ((S + 15) / 16) {
#define SHORT_CASE(NK) \
  case NK:             \
    return short_occupancy<NK>(T, S, ctas_per_sm, threads, smem_bytes);
    SHORT_CASE(1) SHORT_CASE(2) SHORT_CASE(3) SHORT_CASE(4)
    SHORT_CASE(5) SHORT_CASE(6) SHORT_CASE(7) SHORT_CASE(8)
#undef SHORT_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
