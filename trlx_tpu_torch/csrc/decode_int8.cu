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
// in fp32, so a fully masked row averages V uniformly over all S like the
// TPU kernel. Query head h reads kv head h / (H / Hkv).
//
// What bounds it on this card: a decode step reads the int8 K and V rows of
// the layer's attendable slots once and does 4 flops per byte pair, so it is
// bound by those bytes (plus the small scale and mask rows). Left-pad and
// not-yet-written slots are masked and their K rows are never read.
//
// Two routes, chosen by the wrapper from S (decode_route), which the host
// knows without a sync:
// - the short route, S <= 256: decode_int8_short_kernel (its note is at the
//   kernel, below the long route);
// - the long route, any S: decode_int8_kernel, just below.
//
// The long route's design: one CTA per (batch row, kv head) reads the
// group's rep = H / Hkv query rows once into shared memory and streams that
// group's K and V rows of layer `layer_ix` straight from the stacked buffer
// (the layer is an argument, so no per-layer copy exists) with 16-byte
// loads: in the score pass thread t owns slot t of a 128-slot chunk; in the
// P.V pass neighbouring threads read neighbouring 16-byte pieces of the same
// rows. Both dequantisations commute out of the reductions: the K scale
// folds into the scores and the V scale multiplies the normalised output
// once. Any S works; the last chunk is masked. K scales and V rows of slots
// that take no weight are skipped too. The long kernel is instantiated for
// groups of 1, 2, 3, 4 and 8 query rows: a group of 5 to 7 (`rep`, a
// runtime argument) runs in the 8-row instantiation with its extra rows
// zero (the 5- to 7-row ones spilled registers).
//
// Head widths D = 64 (GPT-2) and D = 128 (the Llama family), GQA groups
// H / Hkv = 1..8, on both routes: at D = 128 a slot's int8 row is eight
// 16-byte pieces instead of four (the long route's slot groups halve, the
// short route's score step spreads a slot over eight threads and its P.V
// lanes cover one 128-channel row a warp step instead of two 64-channel
// ones).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"  // cp_async16 / cp_async4, their commit / wait, byte_to_float

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
                   int B, int Hkv, int S, int layer_ix, float sm_scale, int rep) {
  constexpr int NV = D / 16;  // 16-byte pieces per int8 row
  constexpr int SG = NT / NV;  // slot groups of the P.V pass
  // the group's real rows: REP itself below 8 (a constant, as the code the
  // smaller instantiations were built from has it), `rep` in the 8-row one
  const int rows = REP < 8 ? REP : rep;

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

  for (int i = tid; i < REP * D; i += NT) {  // rows past `rows` are zero
    q_s[i / D][i % D] = i < rows * D ? __bfloat162float(q[((long long)bk * rows) * D + i]) : 0.f;
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
  for (int i = tid; i < rows * D; i += NT) {
    const int r = i / D, d = i % D;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) o += red_s[w][r][d];
    o = o / fmaxf(l_s[r], 1e-30f) * vsb[d];
    out[((long long)bk * rows) * D + i] = __float2bfloat16_rn(o);
  }
}

// the long kernel's instantiation for a group of `rep` rows: rep itself up
// to 4, else 8
template <int REP>
constexpr int long_rep() { return REP <= 4 ? REP : 8; }

template <int D, int REP>
int launch(const void* q, const int8_t* ck, const int8_t* cv, const float* ks,
           const float* vs, const int* key_mask, void* out, int B, int Hkv,
           int S, int layer_ix, float sm_scale, cudaStream_t stream) {
  decode_int8_kernel<D, long_rep<REP>()><<<B * Hkv, NT, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), ck, cv, ks, vs, key_mask,
      static_cast<__nv_bfloat16*>(out), B, Hkv, S, layer_ix, sm_scale, REP);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The short route, S <= 256: decode_int8_short_kernel.
//
// The long kernel makes four dependent device-memory round trips in series:
// q, then the mask, then the K row under a branch on the mask, then V under
// a branch on p; int8 goes through the conversion unit, one thread scores a
// whole 64-channel slot, and the online softmax runs although S <= 128 is
// one chunk. The short kernel keeps one CTA per (batch row, kv head) and
// makes two round trips, the second one burst:
// 1. The group's query rows, the mask row (int32 x S), the layer's K-scale
//    row (fp32 x S) and the V-scale row (fp32 x D) depend on nothing: one
//    cp.async group of 16-byte copies (4-byte ones for a row of S not a
//    multiple of 4), one round trip.
// 2. After one barrier, one ballot per warp and 32 slots turns the mask into
//    attendable bits in shared memory; __syncthreads_or flags a row with no
//    attendable slot, whose V then covers all S (the TPU kernel's uniform
//    average).
// 3. One burst of 16-byte cp.async copies: the K rows of every attendable
//    slot (one commit group), then the V rows of every slot that takes
//    weight (a second), V not waiting for p. From here on every loop walks
//    only the span from the first to the last slot that takes weight (in
//    groups of 8 slots): a rollout's left pad and unwritten tail cost no
//    copies and no arithmetic. A masked slot inside the span has its copy
//    issued at the row's base with a source size of 0: zero-filled, nothing
//    read. Every load that feeds a product is unconditional. The rows of one
//    (layer, b, kv head) are contiguous in [L,B,Hkv,S,D] and the left pad
//    and the unwritten tail are runs, so the burst reads contiguous bytes.
//    Each thread moves its share of q to registers while it is in flight.
// 4. Scores once K is in: four neighbouring threads share a slot, 16
//    channels each, and add their parts with two shuffles; int8 becomes fp32
//    by a byte permute and one add (exact). The K scale and sm_scale fold
//    into the score.
// 5. The whole row of scores stays in shared memory (S <= 256 is one tile):
//    one max (the warps' maxima) and one sum a row, no online rescaling.
// 6. P.V once V is in: a lane takes 4 channels of every 8th slot (a warp
//    reads two rows a step, 128 contiguous bytes); its two slot groups
//    meet by one shuffle and the four warps' partials in shared memory,
//    summed in warp order (the same bits on every call). The V scale
//    multiplies the normalised output once.
// No tensor cores: GPT-2 and Llama-2 are MHA (rep = 1), so a CTA has one
// query row, and an MMA tile of 16 rows would waste 15 of them; the 4 flops
// per byte pair suit the CUDA cores. Dynamic shared memory is sized by S
// (about 19 KB at S = 128, rep 1, D = 64; 34 KB at D = 128); an
// instantiation whose largest launch passes 48 KB (rep 8 at S = 256) raises
// its limit once per device. Registers are bounded so that at least eight
// CTAs share an SM at rep 1 and D = 64 (the 768 CTAs of the rollout shape
// fit one wave on 132 SMs; six at D = 128, as many as its shared memory
// allows), four at rep 2 and 3, and two past that (rep 8 holds 128 query
// channels a thread). Two other forms measured slower on the H100 and were
// not kept (PERF.md, kernel 8): the burst as one TMA bulk copy per run of
// slots, and the burst in 32-slot chunks with the scores and P.V of each
// chunk started as it lands.
// ---------------------------------------------------------------------------

constexpr int SHORT_SLOTS = 256;  // the longest cache the short kernel takes
constexpr int SNT = 128;          // threads of a short CTA
constexpr int SNW = SNT / 32;

// Byte offsets of the short kernel's shared arrays, all 16-byte aligned, and
// their total, for a cache of S slots and head width HD
struct ShortSmem {
  int k, v, q, mask, ks, vs, p, bits, red, part, total;
};

template <int REP, int HD>
__host__ __device__ __forceinline__ ShortSmem short_smem(int S) {
  const int SP = (S + 15) & ~15;
  ShortSmem m;
  int o = 0;
  m.k = o;
  o += SP * HD;
  m.v = o;
  o += SP * HD;
  m.q = o;
  o += REP * HD * 2;
  m.mask = o;
  o += SP * 4;
  m.ks = o;
  o += SP * 4;
  m.vs = o;
  o += HD * 4;
  m.p = o;
  o += REP * SP * 4;
  m.bits = o;
  o += SHORT_SLOTS / 8;
  m.red = o;
  o += (2 * SNW * REP * 4 + 15) & ~15;
  m.part = o;
  o += SNW * REP * HD * 4;
  m.total = o;
  return m;
}

// 16 int8 channels (one 16-byte piece) as floats, by byte permute
__device__ __forceinline__ void piece_to_float(const uint4& x, float (&f)[16]) {
  const uint32_t w[4] = {x.x ^ 0x80808080u, x.y ^ 0x80808080u, x.z ^ 0x80808080u, x.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) f[4 * i + j] = byte_to_float(w[i], j);
}

template <int REP, int HD>
__global__ void __launch_bounds__(SNT, REP == 1 ? (HD == 64 ? 8 : 6) : (REP <= 3 ? 4 : 2))
decode_int8_short_kernel(const __nv_bfloat16* __restrict__ q,
                         const int8_t* __restrict__ ck, const int8_t* __restrict__ cv,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ key_mask,
                         __nv_bfloat16* __restrict__ out,
                         int B, int Hkv, int S, int layer_ix, float sm_scale) {
  constexpr int NPC = HD / 16;  // 16-byte pieces of an int8 row, the threads that score a slot
  constexpr int LPR = HD / 4;   // P.V lanes a V row (4 channels each)
  constexpr int RPW = 32 / LPR; // V rows a warp step
  extern __shared__ __align__(16) unsigned char smem[];
  const int SP = (S + 15) & ~15;
  const ShortSmem at = short_smem<REP, HD>(S);
  uint4* k_s = reinterpret_cast<uint4*>(smem + at.k);  // [SP][NPC]
  uint4* v_s = reinterpret_cast<uint4*>(smem + at.v);  // [SP][NPC]
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + at.q);  // [REP][HD]
  int* mask_s = reinterpret_cast<int*>(smem + at.mask);
  float* ks_s = reinterpret_cast<float*>(smem + at.ks);
  float* vs_s = reinterpret_cast<float*>(smem + at.vs);
  float* p_s = reinterpret_cast<float*>(smem + at.p);  // [REP][SP]: s, then p
  unsigned* bits_s = reinterpret_cast<unsigned*>(smem + at.bits);  // attendable slots, 32 a word
  float* max_s = reinterpret_cast<float*>(smem + at.red);  // [SNW][REP]
  float* sum_s = max_s + SNW * REP;  // [SNW][REP]
  float* part_s = reinterpret_cast<float*>(smem + at.part);  // [SNW][REP][HD]

  const int bk = blockIdx.x;  // b * Hkv + kv head
  const int b = bk / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row0 = (static_cast<long long>(layer_ix) * B * Hkv + bk) * S;  // first slot row
  const int8_t* kb = ck + row0 * HD;
  const int8_t* vb = cv + row0 * HD;
  const float* ksb = k_scale + row0;
  const int* mb = key_mask + static_cast<long long>(b) * S;

  // 1. trip 1: q rows, the mask row, the K-scale row and the V-scale row
  for (int x = tid; x < REP * HD / 8; x += SNT)
    cp_async16(&q_s[8 * x], q + static_cast<long long>(bk) * REP * HD + 8 * x, true);
  if (S % 4 == 0) {  // both rows start 16-byte aligned (the wrapper aligns the bases)
    for (int x = tid; x < S / 4; x += SNT) {
      cp_async16(&mask_s[4 * x], mb + 4 * x, true);
      cp_async16(&ks_s[4 * x], ksb + 4 * x, true);
    }
  } else {
    for (int x = tid; x < S; x += SNT) {
      cp_async4(&mask_s[x], mb + x, true);
      cp_async4(&ks_s[x], ksb + x, true);
    }
  }
  for (int x = tid; x < HD / 4; x += SNT) cp_async16(&vs_s[4 * x], v_scale + static_cast<long long>(bk) * HD + 4 * x, true);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // 2. the mask ballot: word w of bits_s holds slots 32w .. 32w + 31
  bool mine = false;
  for (int w = warp; w < (SP + 31) / 32; w += SNW) {
    const int j = w * 32 + lane;
    const unsigned word = __ballot_sync(0xffffffffu, j < S && mask_s[j] > 0);
    if (lane == 0) bits_s[w] = word;
    mine |= word != 0u;
  }
  const bool any = __syncthreads_or(mine);  // some slot is attendable
  // the span [lo, hi) from the first to the last slot that takes weight
  // (every slot < S when none is attendable), widened to whole groups of 8
  // slots (a warp's step in the scores): every loop below walks it alone
  int lo = 0, hi = S;
  if (any) {
    lo = SP;
    for (int w = 0; w < (SP + 31) / 32; ++w) {
      const unsigned word = bits_s[w];
      if (word != 0u) {
        lo = min(lo, w * 32 + __ffs(word) - 1);
        hi = w * 32 + 32 - __clz(word);
      }
    }
  }
  lo &= ~7;
  hi = (hi + 7) & ~7;  // <= SP

  // 3. the K/V burst over the span: K of every attendable slot, then V of
  // every slot that takes weight; the span's other slots zero-filled
  for (int x = lo * NPC + tid; x < hi * NPC; x += SNT) {
    const int j = x / NPC;
    const bool att = (bits_s[j >> 5] >> (j & 31)) & 1u;
    cp_async16(&k_s[x], kb + (att ? x * 16 : 0), att);
  }
  cp_async_commit();
  for (int x = lo * NPC + tid; x < hi * NPC; x += SNT) {
    const int j = x / NPC;
    const bool need = any ? ((bits_s[j >> 5] >> (j & 31)) & 1u) != 0u : j < S;
    cp_async16(&v_s[x], vb + (need ? x * 16 : 0), need);
  }
  cp_async_commit();
  const int quarter = lane & (NPC - 1);  // the 16 channels of a slot this thread scores
  float qreg[REP][16];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const uint4* qp = reinterpret_cast<const uint4*>(q_s + r * HD + quarter * 16);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 x = qp[h];
      const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        qreg[r][8 * h + 2 * i] = f.x;
        qreg[r][8 * h + 2 * i + 1] = f.y;
      }
    }
  }

  // 4. scores once K is in: NPC neighbouring threads share a slot, 16
  // channels each; s = (q . k) * (k_scale * sm_scale) on an attendable slot, 0 on
  // every slot < S of a row with none (the uniform average), -inf elsewhere;
  // each warp's row maxima go to max_s
  cp_async_wait_group<1>();
  __syncthreads();
  float mx[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) mx[r] = neg_infinity();
  const float masked = any ? neg_infinity() : 0.f;
  for (int x = lo * NPC + tid; x < hi * NPC; x += SNT) {  // a whole warp takes each step ((hi - lo) * NPC is a multiple of 32)
    const int j = x / NPC;
    const bool att = (bits_s[j >> 5] >> (j & 31)) & 1u;
    float kf[16];
    piece_to_float(k_s[x], kf);
    const float scale = ks_s[j] * sm_scale;
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) dot += qreg[r][i] * kf[i];
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      if constexpr (NPC == 8) dot += __shfl_xor_sync(0xffffffffu, dot, 4);
      const float sc = att ? dot * scale : (j < S ? masked : neg_infinity());
      if (r % NPC == quarter) p_s[r * SP + j] = sc;
      mx[r] = fmaxf(mx[r], sc);
    }
  }
#pragma unroll
  for (int r = 0; r < REP; ++r) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], o));
    if (lane == 0) max_s[warp * REP + r] = mx[r];
  }

  // 5. softmax over the whole row: m from the warps' maxima, p = exp(s - m)
  // in place (0 where s = -inf), each warp's sums to sum_s
  __syncthreads();
  float m[REP], l[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = max_s[r];
#pragma unroll
    for (int w = 1; w < SNW; ++w) m[r] = fmaxf(m[r], max_s[w * REP + r]);
    l[r] = 0.f;
  }
  for (int j = lo + tid; j < hi; j += SNT) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float sc = p_s[r * SP + j];
      const float e = sc == neg_infinity() ? 0.f : __expf(sc - m[r]);
      p_s[r * SP + j] = e;
      l[r] += e;
    }
  }
#pragma unroll
  for (int r = 0; r < REP; ++r) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
    if (lane == 0) sum_s[warp * REP + r] = l[r];
  }

  // 6. P.V once V is in: lane (half, c4) of warp w accumulates channels
  // 4 c4 .. 4 c4 + 3 over the slots lo + sg, lo + sg + RPW * 4, ... of slot
  // group sg = RPW w + half (RPW = 2 rows a warp step at D = 64, one at
  // D = 128: 128 contiguous bytes); at D = 64 the halves meet by one
  // shuffle; the warps' partials meet in shared memory, summed in warp order
  cp_async_wait_group<0>();
  __syncthreads();
  const int c4 = lane % LPR, sg = warp * RPW + lane / LPR;
  const unsigned char* v_bytes = reinterpret_cast<const unsigned char*>(v_s);
  float acc[REP][4];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
#pragma unroll 2
  for (int j = lo + sg; j < hi; j += RPW * SNW) {  // (hi - lo) / (RPW * 4) steps for every thread
    const uint32_t w = *reinterpret_cast<const uint32_t*>(v_bytes + j * HD + c4 * 4) ^ 0x80808080u;
    float vf[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) vf[i] = byte_to_float(w, i);
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float p = p_s[r * SP + j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][i] += p * vf[i];
    }
  }
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if constexpr (RPW == 2) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][i] += __shfl_xor_sync(0xffffffffu, acc[r][i], 16);
    }
    if (lane < LPR)
      *reinterpret_cast<float4*>(&part_s[(warp * REP + r) * HD + c4 * 4]) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();
  for (int x = tid; x < REP * HD / 2; x += SNT) {
    const int r = x / (HD / 2), c = (x % (HD / 2)) * 2;
    float o0 = 0.f, o1 = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < SNW; ++w) {
      const float2 pw = *reinterpret_cast<const float2*>(&part_s[(w * REP + r) * HD + c]);
      o0 += pw.x;
      o1 += pw.y;
      lsum += sum_s[w * REP + r];
    }
    const float lm = fmaxf(lsum, 1e-30f);
    *reinterpret_cast<__nv_bfloat162*>(out + (static_cast<long long>(bk) * REP + r) * HD + c) =
        __floats2bfloat162_rn(o0 / lm * vs_s[c], o1 / lm * vs_s[c + 1]);
  }
}

// raises the short kernel's dynamic shared memory limit to its largest
// launch (S = SHORT_SLOTS) once per device, where that passes the default
// 48 KB; returns a CUDA error code
template <int REP, int HD>
int short_prepare() {
  const int most = short_smem<REP, HD>(SHORT_SLOTS).total;
  if (most <= 48 * 1024) return 0;
  static unsigned long long done = 0;  // one bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && (done >> dev & 1ULL)) return 0;
  err = cudaFuncSetAttribute(decode_int8_short_kernel<REP, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64) done |= 1ULL << dev;
  return 0;
}

template <int REP, int HD>
int launch_short(const void* q, const int8_t* ck, const int8_t* cv, const float* ks,
                 const float* vs, const int* key_mask, void* out, int B, int Hkv,
                 int S, int layer_ix, float sm_scale, cudaStream_t stream) {
  const int rc = short_prepare<REP, HD>();
  if (rc != 0) return rc;
  decode_int8_short_kernel<REP, HD><<<B * Hkv, SNT, short_smem<REP, HD>(S).total, stream>>>(
      static_cast<const __nv_bfloat16*>(q), ck, cv, ks, vs, key_mask,
      static_cast<__nv_bfloat16*>(out), B, Hkv, S, layer_ix, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// f(std::integral_constant<int, D>{}, std::integral_constant<int, REP>{}) for
// D in {64, 128} and REP in 1..8; cudaErrorInvalidValue otherwise
template <typename F>
int by_shape(int D, int rep, F&& f) {
  auto with_rep = [&](auto d) -> int {
    switch (rep) {
      case 1: return f(d, std::integral_constant<int, 1>{});
      case 2: return f(d, std::integral_constant<int, 2>{});
      case 3: return f(d, std::integral_constant<int, 3>{});
      case 4: return f(d, std::integral_constant<int, 4>{});
      case 5: return f(d, std::integral_constant<int, 5>{});
      case 6: return f(d, std::integral_constant<int, 6>{});
      case 7: return f(d, std::integral_constant<int, 7>{});
      case 8: return f(d, std::integral_constant<int, 8>{});
    }
    return static_cast<int>(cudaErrorInvalidValue);
  };
  if (D == 64) return with_rep(std::integral_constant<int, 64>{});
  if (D == 128) return with_rep(std::integral_constant<int, 128>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// All tensors contiguous. q/out [B,H,D] bf16, ck/cv [L,B,Hkv,S,D] int8,
// k_scale [L,B,Hkv,1,S] f32, v_scale [B,Hkv,1,D] f32, key_mask [B,S] int32.
// Built for D in {64, 128} and H / Hkv in 1..8. Returns cudaGetLastError(),
// or cudaErrorInvalidValue for an unsupported (D, H / Hkv).
extern "C" int decode_int8_bf16(const void* q, const int8_t* ck, const int8_t* cv,
                                const float* k_scale, const float* v_scale,
                                const int* key_mask, void* out, int B, int H,
                                int Hkv, int S, int D, int layer_ix,
                                float sm_scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hkv < 1 || H % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  return by_shape(D, H / Hkv, [&](auto d, auto r) {
    return launch<decltype(d)::value, decltype(r)::value>(q, ck, cv, k_scale, v_scale, key_mask, out, B, Hkv, S,
                                                          layer_ix, sm_scale, st);
  });
}

// The short route: the arguments of decode_int8_bf16, for caches of S <= 256
// slots. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for unsupported arguments (a longer cache included).
extern "C" int decode_int8_short_bf16(const void* q, const int8_t* ck, const int8_t* cv,
                                      const float* k_scale, const float* v_scale,
                                      const int* key_mask, void* out, int B, int H,
                                      int Hkv, int S, int D, int layer_ix,
                                      float sm_scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hkv < 1 || H % Hkv || B < 1 || S < 1 || S > SHORT_SLOTS)
    return static_cast<int>(cudaErrorInvalidValue);
  return by_shape(D, H / Hkv, [&](auto d, auto r) {
    return launch_short<decltype(r)::value, decltype(d)::value>(q, ck, cv, k_scale, v_scale, key_mask, out, B,
                                                                Hkv, S, layer_ix, sm_scale, st);
  });
}

// What a launch at this shape gets on the current card: CTAs an SM, threads
// a CTA and dynamic shared memory. `short_route` selects the kernel.
extern "C" int decode_int8_occupancy(int short_route, int H, int Hkv, int S, int D, int* ctas_per_sm,
                                     int* threads, int* smem_bytes) {
  if (Hkv < 1 || H % Hkv || S < 1 || (short_route && S > SHORT_SLOTS))
    return static_cast<int>(cudaErrorInvalidValue);
  return by_shape(D, H / Hkv, [&](auto d, auto r) {
    constexpr int HD = decltype(d)::value, REP = decltype(r)::value;
    if (short_route) {
      const int rc = short_prepare<REP, HD>();
      if (rc != 0) return rc;
      *threads = SNT;
      *smem_bytes = short_smem<REP, HD>(S).total;
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          ctas_per_sm, decode_int8_short_kernel<REP, HD>, SNT, *smem_bytes));
    }
    *threads = NT;
    *smem_bytes = 0;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas_per_sm, decode_int8_kernel<HD, long_rep<REP>()>, NT, 0));
  });
}

extern "C" const char* decode_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
