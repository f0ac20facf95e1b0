// Attention of T queries per decode lane over that lane's pages of a paged
// KV pool, for Hopper (sm_90a).
//
// Replaces: trlx_tpu/ops/decode_attention.py : paged_attention_pallas /
// _paged_kernel (the engine's decode step, its draft steps and its
// speculative verify).
//
// Computes, for q [B,T,H,D] (bf16), one layer `layer_ix` of the pools
// pk/pv [L,NP,PS,Hkv,D] (int8 with fp32 per-row scales [L,NP,PS,Hkv], or
// bf16 without), the page table [B,MP] (int32) and the additive bias
// [B,1,T,MP*PS] (fp32): for lane b, query token t, query head h and kv head
// g = h / (H / Hkv), over the lane's logical slots j (page
// page_table[b, j / PS], row j % PS):
//   s_j = (q . k_j) * sm_scale * k_scale_j + bias[b, t, j]
//   o   = sum_j exp(s_j - m) * v_scale_j * v_j / max(l, 1e-30)
// with the online softmax (m, l) in fp32; o is written in bf16, [B,T,H,D].
// Slots of a null page (table entry 0) are skipped: their K and V are never
// read. That equals attending them under the bias (the engine never marks
// a null-page slot visible, and exp(-1e9 - m) is 0) for every row that has
// a visible slot; rows with none belong to retired lanes, whose output is
// never read.
//
// What bounds it on this card: each lane reads its visible K and V rows
// once (64 int8 or bf16 values a row, plus the per-row scales), and does 4
// flops per K/V element pair for each of its rep * T query rows, with
// rep * T <= 32: a few flops per byte, so bytes bound it. The design: one
// CTA per (lane, kv head) walks the lane's logical slots in chunks of 128.
// In the score pass thread i owns slot i of the chunk: it looks the slot's
// page up in the table, reads the K row with 16-byte loads and the group's
// rep * T query rows from shared memory, folds the K scale into the scores
// and adds the bias; it also copies the V row into shared memory. A warp per
// query row then updates the online softmax and folds the V scale into the
// probabilities, and in the P.V pass each thread owns one channel of half
// the rows. The TPU walks a (lane, page) grid in order and carries the
// accumulators from page to page; here the page loop is inside the CTA, so
// nothing crosses CTAs. Scores and P.V are fp32 dot products on the CUDA
// cores: at rep * T <= 32 rows tensor cores would buy nothing yet. Any page
// size works: the last chunk is masked. Splitting long lanes over CTAs and
// pipelining the page loads is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // threads per CTA, and slots per chunk
constexpr int NWARPS = NT / 32;
constexpr int HD = 64;  // head width
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float neg_infinity() { return -__int_as_float(0x7f800000); }

__device__ __forceinline__ void piece_to_float(const uint4& x, float (&f)[16]) {  // 16 int8
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[i * 4 + j] = static_cast<float>(static_cast<int8_t>((w[i] >> (8 * j)) & 0xffu));
}

__device__ __forceinline__ void piece_to_float(const uint4& x, float (&f)[8]) {  // 8 bf16
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ float elem_to_float(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float elem_to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// KV: int8_t (with per-row scales) or __nv_bfloat16 (without).
// RMAX: rows of shared query storage, >= rep * T.
template <typename KV, int RMAX>
__global__ void __launch_bounds__(NT)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const KV* __restrict__ pk, const KV* __restrict__ pv,
                       const float* __restrict__ pk_scale,
                       const float* __restrict__ pv_scale,
                       const int* __restrict__ page_table,
                       const float* __restrict__ bias,
                       __nv_bfloat16* __restrict__ out,
                       int T, int H, int Hkv, int NP, int PS, int MP,
                       int layer_ix, float sm_scale) {
  constexpr bool QUANT = sizeof(KV) == 1;
  constexpr int EPP = 16 / sizeof(KV);  // elements per 16-byte piece
  constexpr int NV = HD / EPP;  // pieces per row
  constexpr int RH = (RMAX + 1) / 2;  // rows per thread in the P.V pass

  __shared__ float q_s[RMAX][HD];
  __shared__ float p_s[RMAX][NT];
  __shared__ __align__(16) KV v_s[NT][HD];
  __shared__ float vs_s[NT];
  __shared__ float m_s[RMAX], l_s[RMAX], corr_s[RMAX];

  const int b = blockIdx.x / Hkv, g = blockIdx.x % Hkv;
  const int rep = H / Hkv, R = rep * T;
  const int S = MP * PS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int* table = page_table + (long long)b * MP;

  // the group's query rows: row r = t * rep + i is head g * rep + i at token t
  for (int x = tid; x < RMAX * HD; x += NT) {
    const int r = x / HD, d = x % HD;
    float v = 0.f;
    if (r < R) {
      const int t = r / rep, h = g * rep + r % rep;
      v = __bfloat162float(q[(((long long)b * T + t) * H + h) * HD + d]);
    }
    q_s[r][d] = v;
  }
  if (tid < RMAX) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  const int d_own = tid % HD, half = tid / HD;  // P.V pass: channel, row parity
  float acc[RH];
#pragma unroll
  for (int i = 0; i < RH; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int c0 = 0; c0 < S; c0 += NT) {
    // scores: thread tid owns slot c0 + tid
    const int slot = c0 + tid;
    int pid = 0, off = 0;
    if (slot < S) {
      pid = table[slot / PS];
      off = slot % PS;
    }
    uint4* vrow_s = reinterpret_cast<uint4*>(&v_s[tid][0]);
    if (pid != 0) {
      const long long row = (((long long)layer_ix * NP + pid) * PS + off) * Hkv + g;
      const uint4* kr = reinterpret_cast<const uint4*>(pk + row * HD);
      const uint4* vr = reinterpret_cast<const uint4*>(pv + row * HD);
      float dot[RMAX];
#pragma unroll
      for (int r = 0; r < RMAX; ++r) dot[r] = 0.f;
#pragma unroll
      for (int p = 0; p < NV; ++p) {
        float kf[EPP];
        piece_to_float(kr[p], kf);
#pragma unroll
        for (int i = 0; i < EPP; ++i)
#pragma unroll
          for (int r = 0; r < RMAX; ++r) dot[r] += q_s[r][p * EPP + i] * kf[i];
      }
#pragma unroll
      for (int p = 0; p < NV; ++p) vrow_s[p] = vr[p];
      const float ks = QUANT ? pk_scale[row] : 1.f;
      vs_s[tid] = QUANT ? pv_scale[row] : 1.f;
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        if (r < R) {
          const int t = r / rep;
          p_s[r][tid] = dot[r] * sm_scale * ks + bias[((long long)b * T + t) * S + slot];
        }
      }
    } else {
      // past the end or on a null page: no weight, and zeros in v_s so
      // that 0 * v stays 0
#pragma unroll
      for (int p = 0; p < NV; ++p) vrow_s[p] = make_uint4(0u, 0u, 0u, 0u);
      vs_s[tid] = 0.f;
      for (int r = 0; r < R; ++r) p_s[r][tid] = neg_infinity();
    }
    __syncthreads();

    // online-softmax update: warp w owns rows w, w + 4, ...; the V scale
    // rides the probabilities after l has summed them
    for (int r = warp; r < R; r += NWARPS) {
      const float m_old = m_s[r];
      float x[NT / 32];
      float mx = NEG_INF;
#pragma unroll
      for (int i = 0; i < NT / 32; ++i) {
        x[i] = p_s[r][lane + 32 * i];
        mx = fmaxf(mx, x[i]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < NT / 32; ++i) {
        const float p = __expf(x[i] - m_new);
        sum += p;
        p_s[r][lane + 32 * i] = p * vs_s[lane + 32 * i];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float corr = __expf(m_old - m_new);
        corr_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // P.V: thread (half, d_own) accumulates channel d_own of rows half, half + 2, ...
    const int n_slots = min(NT, S - c0);
#pragma unroll
    for (int i = 0; i < RH; ++i) {
      const int r = half + 2 * i;
      if (r < R) acc[i] *= corr_s[r];
    }
    for (int sl = 0; sl < n_slots; ++sl) {
      const float v = elem_to_float(v_s[sl][d_own]);
#pragma unroll
      for (int i = 0; i < RH; ++i) {
        const int r = half + 2 * i;
        if (r < R) acc[i] += p_s[r][sl] * v;
      }
    }
    __syncthreads();  // p_s and v_s are rewritten by the next chunk
  }

#pragma unroll
  for (int i = 0; i < RH; ++i) {
    const int r = half + 2 * i;
    if (r < R) {
      const int t = r / rep, h = g * rep + r % rep;
      out[(((long long)b * T + t) * H + h) * HD + d_own] =
          __float2bfloat16_rn(acc[i] / fmaxf(l_s[r], 1e-30f));
    }
  }
}

template <typename KV, int RMAX>
void launch(const void* q, const void* pk, const void* pv, const float* pks,
            const float* pvs, const int* table, const float* bias, void* out,
            int B, int T, int H, int Hkv, int NP, int PS, int MP, int layer_ix,
            float sm_scale, cudaStream_t stream) {
  paged_attention_kernel<KV, RMAX><<<B * Hkv, NT, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(pk),
      static_cast<const KV*>(pv), pks, pvs, table, bias,
      static_cast<__nv_bfloat16*>(out), T, H, Hkv, NP, PS, MP, layer_ix, sm_scale);
}

template <typename KV>
int dispatch(int R, const void* q, const void* pk, const void* pv, const float* pks,
             const float* pvs, const int* table, const float* bias, void* out, int B,
             int T, int H, int Hkv, int NP, int PS, int MP, int layer_ix,
             float sm_scale, cudaStream_t st) {
#define PAGED_LAUNCH(RM) \
  launch<KV, RM>(q, pk, pv, pks, pvs, table, bias, out, B, T, H, Hkv, NP, PS, MP, layer_ix, sm_scale, st)
  if (R <= 1) PAGED_LAUNCH(1);
  else if (R <= 4) PAGED_LAUNCH(4);
  else if (R <= 8) PAGED_LAUNCH(8);
  else if (R <= 16) PAGED_LAUNCH(16);
  else PAGED_LAUNCH(32);
#undef PAGED_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All tensors contiguous. q/out [B,T,H,D] bf16; pk/pv [L,NP,PS,Hkv,D] int8
// (quant = 1, with pk_scale/pv_scale [L,NP,PS,Hkv] fp32) or bf16 (quant = 0,
// scales ignored); page_table [B,MP] int32; bias [B,1,T,MP*PS] fp32. Built
// for D = 64 and (H / Hkv) * T <= 32. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for unsupported arguments.
extern "C" int paged_attention_bf16(const void* q, const void* pk, const void* pv,
                                    const float* pk_scale, const float* pv_scale,
                                    const int* page_table, const float* bias, void* out,
                                    int B, int T, int H, int Hkv, int D, int NP, int PS,
                                    int MP, int layer_ix, int quant, float sm_scale,
                                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != HD || Hkv < 1 || H % Hkv || T < 1 || PS < 1 || MP < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int R = (H / Hkv) * T;
  if (R > 32 || (quant && (pk_scale == nullptr || pv_scale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (quant)
    return dispatch<int8_t>(R, q, pk, pv, pk_scale, pv_scale, page_table, bias, out, B, T, H,
                            Hkv, NP, PS, MP, layer_ix, sm_scale, st);
  return dispatch<__nv_bfloat16>(R, q, pk, pv, nullptr, nullptr, page_table, bias, out, B, T,
                                 H, Hkv, NP, PS, MP, layer_ix, sm_scale, st);
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
