// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax state.
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
// A faster version (TMA, wgmma, warp specialisation) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per CTA: 4 warps x 16 rows
constexpr int BK = 64;         // key slots per shared-memory tile
constexpr int NTHREADS = 128;
constexpr float NEG_INF = -1e30f;
__device__ __forceinline__ float neg_infinity() { return -__int_as_float(0x7f800000); }

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// d += a (16x16, row major) * b (16x8, column major); bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment layout of mma.m16n8k16 (g = lane / 4, c = lane % 4):
//   A reg0: row g,   k 2c..2c+1   reg1: row g+8, k 2c..2c+1
//     reg2: row g,   k 2c+8..+9   reg3: row g+8, k 2c+8..+9
//   B reg0: k 2c..2c+1, col g     reg1: k 2c+8..+9, col g
//   C/D [0,1]: row g, cols 2c..2c+1   [2,3]: row g+8, cols 2c..2c+1
// At most 128 registers a thread, so that four CTAs share an SM: the
// teacher-forced pass launches B*H*ceil(T/64) CTAs, several waves of them.
template <int D>
__global__ void __launch_bounds__(NTHREADS, 4)
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
// the last dimension of each is contiguous. Built for D = 64 (GPT-2's head
// width); other widths are instantiated with the model that needs them.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for another D.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              const int* key_mask, void* out, float* m, float* l,
                              int B, int H, int Hkv, int T, int S, int D,
                              const long long* strides, int causal, int q_offset,
                              float sm_scale, void* stream) {
  if (D != 64) return static_cast<int>(cudaErrorInvalidValue);
  launch<64>(q, k, v, key_mask, out, m, l, B, H, Hkv, T, S, strides, causal,
             q_offset, sm_scale, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
