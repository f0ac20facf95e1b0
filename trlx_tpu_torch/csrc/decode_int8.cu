// One decode step of attention over the stacked int8 KV cache, for Hopper
// (sm_90a).
//
// Replaces: trlx_tpu/ops/decode_attention.py : decode_attention_int8 /
// _decode_kernel.
//
// Computes, for q [B,H,D] (bf16), the layer `layer_ix` of the int8 caches
// ck/cv [L,B,Hkv,S,D], the per-slot K scales [L,B,Hkv,1,S], this layer's
// per-channel V scales [B,Hkv,1,D] and key_mask [B,S]:
//   s[j] = (q . ck[j]) * (k_scale[j] * sm_scale), or -1e30 where key_mask == 0
//   out  = (sum_j exp(s - m) cv[j]) / max(l, 1e-30) * v_scale
// with the online softmax (m, l) in fp32, so a fully masked row averages
// uniformly like the TPU kernel.
//
// What bounds it on this card: a decode step reads the int8 K and V rows of
// the layer's attendable slots once and does 4 flops per byte pair, so it is
// bound by those bytes (plus the small scale and mask rows). Left-pad and
// not-yet-written slots are masked; their K rows and K scales are skipped,
// and so are the V rows of slots that take no weight. The design: one
// CTA per (batch row, kv head) reads the group's rep = H / Hkv query rows once
// into shared memory and streams that group's K and V rows of layer
// `layer_ix` straight from the stacked buffer (the layer is an argument, so
// no per-layer copy exists) with 16-byte loads: in the score pass thread t
// owns slot t of a 128-slot chunk; in the P.V pass neighbouring threads read
// neighbouring 16-byte pieces of the same rows. Both dequantisations
// commute out of the reductions: the K scale folds into the scores and the
// V scale multiplies the normalised output once. Any S works; the last chunk
// is masked. A faster version (more bytes in flight per SM) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // threads per CTA, and slots per chunk
constexpr int NWARPS = NT / 32;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float neg_infinity() { return -__int_as_float(0x7f800000); }

__device__ __forceinline__ void int8x16_to_float(const uint4& x, float (&f)[16]) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[i * 4 + j] = static_cast<float>(static_cast<int8_t>((w[i] >> (8 * j)) & 0xffu));
    }
  }
}

template <int D, int REP>
__global__ void __launch_bounds__(NT)
decode_int8_kernel(const __nv_bfloat16* __restrict__ q,
                   const int8_t* __restrict__ ck, const int8_t* __restrict__ cv,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ key_mask,
                   __nv_bfloat16* __restrict__ out,
                   int B, int Hkv, int S, int layer_ix, float sm_scale) {
  constexpr int NV = D / 16;  // 16-byte pieces per int8 row
  constexpr int SG = NT / NV;  // slot groups of the P.V pass

  __shared__ float q_s[REP][D];
  __shared__ float p_s[REP][NT];
  __shared__ float m_s[REP], l_s[REP], corr_s[REP];
  __shared__ float red_s[NWARPS][REP][D];

  const int bk = blockIdx.x;  // b * Hkv + kv head
  const int b = bk / Hkv, hk = bk % Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row0 = ((long long)layer_ix * B * Hkv + bk) * S;  // first slot row
  const int8_t* kb = ck + row0 * D;
  const int8_t* vb = cv + row0 * D;
  const float* ksb = k_scale + row0;
  const int* mb = key_mask + (long long)b * S;

  for (int i = tid; i < REP * D; i += NT) {
    q_s[i / D][i % D] = __bfloat162float(q[((long long)bk * REP) * D + i]);
  }
  if (tid < REP) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  const int piece = tid % NV, sg = tid / NV;
  float acc[REP][16];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[r][i] = 0.f;
  __syncthreads();

  for (int c0 = 0; c0 < S; c0 += NT) {
    // scores: thread tid owns slot c0 + tid
    const int slot = c0 + tid;
    if (slot < S) {
      // a masked slot scores -1e30 whatever its K: its K row is never read
      const bool keep = mb[slot] > 0;
      float dot[REP];
#pragma unroll
      for (int r = 0; r < REP; ++r) dot[r] = 0.f;
      if (keep) {
        const uint4* kr = reinterpret_cast<const uint4*>(kb + (long long)slot * D);
#pragma unroll
        for (int p = 0; p < NV; ++p) {
          float kf[16];
          int8x16_to_float(kr[p], kf);
#pragma unroll
          for (int r = 0; r < REP; ++r)
#pragma unroll
            for (int i = 0; i < 16; ++i) dot[r] += q_s[r][p * 16 + i] * kf[i];
        }
      }
      const float scale = keep ? ksb[slot] * sm_scale : 0.f;
#pragma unroll
      for (int r = 0; r < REP; ++r) p_s[r][tid] = keep ? dot[r] * scale : NEG_INF;
    } else {
#pragma unroll
      for (int r = 0; r < REP; ++r) p_s[r][tid] = neg_infinity();  // no weight
    }
    __syncthreads();

    // online-softmax update: warp w owns rows w, w + 4, ...
    for (int r = warp; r < REP; r += NWARPS) {
      const float m_old = m_s[r];
      float x[NT / 32];
      float mx = NEG_INF;
#pragma unroll
      for (int i = 0; i < NT / 32; ++i) {
        x[i] = p_s[r][lane + 32 * i];
        mx = fmaxf(mx, x[i]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < NT / 32; ++i) {
        const float p = __expf(x[i] - m_new);
        p_s[r][lane + 32 * i] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float corr = __expf(m_old - m_new);
        corr_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // P.V: thread (sg, piece) accumulates 16 channels over slots sg, sg + SG, ...
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float corr = corr_s[r];
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[r][i] *= corr;
    }
    for (int sl = sg; sl < NT && c0 + sl < S; sl += SG) {
      // exp(-1e30 - m) is exactly 0 once a row has seen an attendable slot:
      // a slot no row weighs adds nothing, so its V row is not read
      bool weighed = false;
#pragma unroll
      for (int r = 0; r < REP; ++r) weighed |= p_s[r][sl] != 0.f;
      if (!weighed) continue;
      float vf[16];
      int8x16_to_float(
          reinterpret_cast<const uint4*>(vb + (long long)(c0 + sl) * D)[piece], vf);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float p = p_s[r][sl];
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[r][i] += p * vf[i];
      }
    }
    __syncthreads();  // p_s is rewritten by the next chunk
  }

  // sum the slot groups: first across the lanes of a warp that share a
  // piece, then across warps through shared memory
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int off = NV; off < 32; off <<= 1)
        acc[r][i] += __shfl_xor_sync(0xffffffffu, acc[r][i], off);
  if (lane < NV) {
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int i = 0; i < 16; ++i) red_s[warp][r][piece * 16 + i] = acc[r][i];
  }
  __syncthreads();
  const float* vsb = v_scale + (long long)bk * D;
  for (int i = tid; i < REP * D; i += NT) {
    const int r = i / D, d = i % D;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) o += red_s[w][r][d];
    o = o / fmaxf(l_s[r], 1e-30f) * vsb[d];
    out[((long long)bk * REP) * D + i] = __float2bfloat16_rn(o);
  }
}

template <int D, int REP>
void launch(const void* q, const int8_t* ck, const int8_t* cv, const float* ks,
            const float* vs, const int* key_mask, void* out, int B, int Hkv,
            int S, int layer_ix, float sm_scale, cudaStream_t stream) {
  decode_int8_kernel<D, REP><<<B * Hkv, NT, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), ck, cv, ks, vs, key_mask,
      static_cast<__nv_bfloat16*>(out), B, Hkv, S, layer_ix, sm_scale);
}

}  // namespace

// All tensors contiguous. q/out [B,H,D] bf16, ck/cv [L,B,Hkv,S,D] int8,
// k_scale [L,B,Hkv,1,S] f32, v_scale [B,Hkv,1,D] f32, key_mask [B,S] int32.
// Built for D = 64 (GPT-2's head width) and H / Hkv in {1, 3}; other widths
// and group sizes are instantiated with the model that needs them. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unsupported (D, H / Hkv).
extern "C" int decode_int8_bf16(const void* q, const int8_t* ck, const int8_t* cv,
                                const float* k_scale, const float* v_scale,
                                const int* key_mask, void* out, int B, int H,
                                int Hkv, int S, int D, int layer_ix,
                                float sm_scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != 64 || H % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  switch (H / Hkv) {
    case 1: launch<64, 1>(q, ck, cv, k_scale, v_scale, key_mask, out, B, Hkv, S, layer_ix, sm_scale, st); break;
    case 3: launch<64, 3>(q, ck, cv, k_scale, v_scale, key_mask, out, B, Hkv, S, layer_ix, sm_scale, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* decode_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
