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
// Two routes, chosen by the wrapper from the table's width S = MP * PS
// (paged_route), which the host knows without a sync:
// - the short route, S <= 256: paged_attention_short_kernel (its note is at
//   the kernel, below the long route);
// - the long route, any S: paged_attention_kernel, just below.
//
// What bounds it on this card: each lane reads its visible K and V rows
// once (64 int8 or bf16 values a row, plus the per-row scales), and does 4
// flops per K/V element pair for each of its rep * T query rows, with
// rep * T <= 32: a few flops per byte, so bytes bound it. The long route's
// design: one CTA per (lane, kv head) walks the lane's logical slots in
// chunks of 128.
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
//
// Head widths D = 64 (GPT-2) and D = 128 (the Llama family), on both routes.
// At D = 128 the long route does not stage V rows in shared memory (a
// 128-slot chunk of bf16 rows would take the static limit of 48 KB beside
// the query and score rows): the score pass leaves each slot's pool row in
// shared memory, and in the P.V pass thread d reads channel d of each
// weighed slot's V row from device memory (128 threads, one 256-byte bf16
// or 128-byte int8 row a slot), for all the group's rows.
//
// Built with -DKERNEL_HEAD_DIM=64 or 128, a library holds that head width's
// instantiations alone (ops/_build.py builds the two side by side); without
// it, both.

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
// RMAX: rows of shared query storage, >= rep * T. HD: the head width.
template <typename KV, int RMAX, int HD>
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
  constexpr bool VSH = HD == 64;  // V rows staged in shared memory
  constexpr int NHALF = NT / HD;  // row parities of the P.V pass (a thread a channel)
  constexpr int RH = (RMAX + NHALF - 1) / NHALF;  // rows per thread in the P.V pass

  __shared__ float q_s[RMAX][HD];
  __shared__ float p_s[RMAX][NT];
  __shared__ __align__(16) KV v_s[VSH ? NT : 1][VSH ? HD : 8];
  __shared__ long long vrow_s[VSH ? 1 : NT];  // D = 128: each slot's pool row, -1 on none
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
    uint4* vpieces_s = reinterpret_cast<uint4*>(&v_s[VSH ? tid : 0][0]);
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
      if constexpr (VSH) {
#pragma unroll
        for (int p = 0; p < NV; ++p) vpieces_s[p] = vr[p];
      } else {
        vrow_s[tid] = row;
      }
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
      if constexpr (VSH) {
#pragma unroll
        for (int p = 0; p < NV; ++p) vpieces_s[p] = make_uint4(0u, 0u, 0u, 0u);
      } else {
        vrow_s[tid] = -1;
      }
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

    // P.V: thread (half, d_own) accumulates channel d_own of rows half,
    // half + NHALF, ...
    const int n_slots = min(NT, S - c0);
#pragma unroll
    for (int i = 0; i < RH; ++i) {
      const int r = half + NHALF * i;
      if (r < R) acc[i] *= corr_s[r];
    }
    for (int sl = 0; sl < n_slots; ++sl) {
      float v;
      if constexpr (VSH) {
        v = elem_to_float(v_s[sl][d_own]);
      } else {
        const long long vrow = vrow_s[sl];
        if (vrow < 0) continue;  // no weight, nothing read
        v = elem_to_float(pv[vrow * HD + d_own]);
      }
#pragma unroll
      for (int i = 0; i < RH; ++i) {
        const int r = half + NHALF * i;
        if (r < R) acc[i] += p_s[r][sl] * v;
      }
    }
    __syncthreads();  // p_s and v_s are rewritten by the next chunk
  }

#pragma unroll
  for (int i = 0; i < RH; ++i) {
    const int r = half + NHALF * i;
    if (r < R) {
      const int t = r / rep, h = g * rep + r % rep;
      out[(((long long)b * T + t) * H + h) * HD + d_own] =
          __float2bfloat16_rn(acc[i] / fmaxf(l_s[r], 1e-30f));
    }
  }
}

// the instantiation for R query rows and head width D:
// f(std::integral_constant<int, RMAX>, std::integral_constant<int, HD>).
// LONG: the long kernel, which at D = 128 takes up to 8 rows in its 8-row
// instantiation (its 1- and 4-row ones spilled registers)
template <bool LONG = false, typename F>
int by_shape(int R, int D, F&& f) {
  auto with_rows = [&](auto hd) -> int {
    if constexpr (!(LONG && decltype(hd)::value == 128)) {
      if (R <= 1) return f(std::integral_constant<int, 1>{}, hd);
      if (R <= 4) return f(std::integral_constant<int, 4>{}, hd);
    }
    if (R <= 8) return f(std::integral_constant<int, 8>{}, hd);
    if (R <= 16) return f(std::integral_constant<int, 16>{}, hd);
    return f(std::integral_constant<int, 32>{}, hd);
  };
#if !defined(KERNEL_HEAD_DIM) || KERNEL_HEAD_DIM == 64
  if (D == 64) return with_rows(std::integral_constant<int, 64>{});
#endif
#if !defined(KERNEL_HEAD_DIM) || KERNEL_HEAD_DIM == 128
  if (D == 128) return with_rows(std::integral_constant<int, 128>{});
#endif
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename KV>
int dispatch(int R, const void* q, const void* pk, const void* pv, const float* pks,
             const float* pvs, const int* table, const float* bias, void* out, int B,
             int T, int H, int Hkv, int D, int NP, int PS, int MP, int layer_ix,
             float sm_scale, cudaStream_t st) {
  return by_shape<true>(R, D, [&](auto rows, auto hd) {
    paged_attention_kernel<KV, decltype(rows)::value, decltype(hd)::value><<<B * Hkv, NT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(pk),
        static_cast<const KV*>(pv), pks, pvs, table, bias,
        static_cast<__nv_bfloat16*>(out), T, H, Hkv, NP, PS, MP, layer_ix, sm_scale);
    return static_cast<int>(cudaGetLastError());
  });
}

// ---------------------------------------------------------------------------
// The short route: tables of at most SHORT_SLOTS slots.
//
// The same function as the long route, for one (lane, kv head) a CTA. What
// holds the long route back at the engine's shapes (S = 80, 384 CTAs, one
// wave; its stage cut) is steps run one after another: scalar query loads,
// then the table entry, then the K row it names (two device-memory round
// trips before a score), a warp a row for the softmax (three idle at one
// row) and a P.V in which one thread walks every slot of a channel. The
// design: one round trip after the table, with every byte in flight at
// once, and a short tail of arithmetic.
// 1. The table row, the group's query rows and the lane's bias rows [T, S]
//    depend on nothing: one cp.async burst of 16-byte copies (4-byte ones
//    for the table, and for a bias of T * S not a multiple of 4).
// 2. After one barrier, one burst of 16-byte cp.async copies for the K rows
//    and both scales of every slot that is on a non-null page and that
//    some row of the group sees (bias > -5e8 on some row: left padding and
//    the future are not read), then a second commit group for the V rows.
//    Every other slot, up to S rounded to 16, is zero-filled by the copy
//    itself, so every load is unconditional at a clamped address. The
//    thread that copies a slot's first piece decides the slot once and
//    leaves its pool row in row_s for the warp's later copies and the
//    scores. Up to 4 query rows, each thread's share of q moves to
//    registers while the burst is in flight.
// 3. The scores start as soon as K has arrived, while V is in flight: four
//    neighbouring threads share a slot, 16 channels each, all rows of the
//    group, and add their parts with two shuffles (all 128 threads busy at
//    S = 80). int8 becomes fp32 by a byte permute and one add (exact), not
//    by the conversion unit, which converts 16 values a clock an SM.
// 4. The lane's whole row of scores stays in shared memory: no online
//    rescaling, one max (warps' maxima) and one sum per row, after which
//    the V scale is folded into p (one product a row and slot, not one a
//    slot and channel; the scales came with K, so V may still be in
//    flight). A slot not read has p = 0, which is exact for every row with
//    a visible slot (exp(-1e9 - m) is 0 in fp32).
// 5. P.V runs in parallel over slots: warp w takes a quarter of them, lane l
//    channels 2l and 2l + 1 of every row. The four warps' partials meet in
//    shared memory and are summed in a fixed order (the same bits on every
//    call), and the output leaves as 4-byte bf16 pairs. At D = 128 the
//    warps split the channels instead (thread c takes channel c of every
//    row over all the slots): no partials, whose 64 KB at 32 rows would not
//    fit beside the bf16 rows of 256 slots.
// Dynamic shared memory is sized by the launch's S, T and MP (13 KB at the
// engine's decode shape); its limit is raised once per device for the
// largest (bf16 pools at 256 slots and 32 rows, 177 KB at D = 64 and 213 KB
// at D = 128). Registers are bounded so that four CTAs share an SM up to 8
// rows (three past that). At D = 128 a slot is scored by eight threads, 16
// channels each, and K and V rows are twice as long.
// ---------------------------------------------------------------------------

constexpr int SHORT_SLOTS = 256;   // the widest table (MP * PS) the short kernel takes
constexpr int SNT = 128;           // threads of a short CTA
constexpr int SNW = SNT / 32;
constexpr float SEEN_BIAS = -5e8f; // a slot with bias <= this on every row is not read

// 16 channels of a K row in shared memory (one 16-byte piece of int8, two
// of bf16) as floats
__device__ __forceinline__ void k16_to_float(const uint4* p, float (&f)[16], int8_t) {
  const uint32_t w[4] = {p->x ^ 0x80808080u, p->y ^ 0x80808080u, p->z ^ 0x80808080u, p->w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) f[4 * i + j] = byte_to_float(w[i], j);
}

__device__ __forceinline__ void k16_to_float(const uint4* p, float (&f)[16], __nv_bfloat16) {
  float lo[8], hi[8];
  piece_to_float(p[0], lo);
  piece_to_float(p[1], hi);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    f[i] = lo[i];
    f[8 + i] = hi[i];
  }
}

// channels c * 16 .. c * 16 + 15 of query row r (bf16 in shared memory)
template <int HD>
__device__ __forceinline__ void q16_to_float(const __nv_bfloat16* q_s, int r, int c, float (&f)[16]) {
  k16_to_float(reinterpret_cast<const uint4*>(q_s + r * HD + c * 16), f, __nv_bfloat16());
}

__device__ __forceinline__ void v_pair(const int8_t* p, float& a, float& b) {
  const uint32_t w = *reinterpret_cast<const uint16_t*>(p) ^ 0x8080u;
  a = byte_to_float(w, 0);
  b = byte_to_float(w, 1);
}

__device__ __forceinline__ void v_pair(const __nv_bfloat16* p, float& a, float& b) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  a = f.x;
  b = f.y;
}

// K and V rows in shared memory: int8 rows unpadded (the four threads of
// a slot read its four pieces, two slots a quarter-warp: no bank
// conflicts), bf16 rows padded by one piece (each thread reads two)
template <typename KV, int HD>
__host__ __device__ constexpr int short_row_pieces() {
  return sizeof(KV) == 1 ? HD / 16 : HD / 8 + 1;
}

// Byte offsets of the short kernel's shared arrays, all 16-byte aligned,
// and their total, for T tokens, S slots and MP pages
struct ShortSmem {
  int k, v, q, bias, ks, vs, p, part, red, row, table, total;
};

template <typename KV, int RMAX, int HD>
__host__ __device__ __forceinline__ ShortSmem short_smem(int T, int S, int MP) {
  constexpr int ROW = short_row_pieces<KV, HD>() * 16;
  const int SP = (S + 15) & ~15;
  ShortSmem m;
  int o = 0;
  m.k = o;
  o += SP * ROW;
  m.v = o;
  o += SP * ROW;
  m.q = o;
  o += RMAX * HD * 2;
  m.bias = o;
  o += (T * S * 4 + 15) & ~15;
  m.ks = o;
  o += SP * 4;
  m.vs = o;
  o += SP * 4;
  m.p = o;
  o += RMAX * SP * 4;
  m.part = o;
  o += HD == 64 ? SNW * RMAX * HD * 4 : 0;  // D = 128 sums no partials
  m.red = o;
  o += 2 * SNW * RMAX * 4;
  m.row = o;
  o += SP * 4;
  m.table = o;
  o += (MP * 4 + 15) & ~15;
  m.total = o;
  return m;
}

// The pool row (of the [L, NP, PS, Hkv] rows) of slot j for kv head g, or
// -1 when slot j is past the table, on a null page, or seen by no row of
// the group
__device__ __forceinline__ int short_slot_row(const int* table_s, const float* bias_s, int j, int S, int T,
                                              int PS, int Hkv, int g, int page0) {
  if (j >= S) return -1;
  const int pg = j / PS;
  const int pid = table_s[pg];
  bool seen = false;
  for (int t = 0; t < T; ++t) seen |= bias_s[t * S + j] > SEEN_BIAS;
  if (pid == 0 || !seen) return -1;
  return ((page0 + pid) * PS + (j - pg * PS)) * Hkv + g;
}

// KV: int8_t (with per-row scales) or __nv_bfloat16 (without).
// RMAX: query rows of the group the instantiation holds, >= rep * T.
// HD: the head width, 64 or 128.
template <typename KV, int RMAX, int HD>
__global__ void __launch_bounds__(SNT, RMAX <= 8 ? 4 : 3)
paged_attention_short_kernel(const __nv_bfloat16* __restrict__ q,
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
  constexpr int NV = HD / EPP;          // pieces per K or V row
  constexpr int LDR = short_row_pieces<KV, HD>();  // shared row stride in pieces
  constexpr int NQ = HD / 16;           // threads that score one slot, 16 channels each
  constexpr bool QREG = RMAX <= 4;      // the thread's q channels live in registers
  extern __shared__ __align__(16) unsigned char smem[];

  const int S = MP * PS, SP = (S + 15) & ~15;
  const ShortSmem at = short_smem<KV, RMAX, HD>(T, S, MP);
  uint4* k_s = reinterpret_cast<uint4*>(smem + at.k);
  uint4* v_s = reinterpret_cast<uint4*>(smem + at.v);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + at.q);
  float* bias_s = reinterpret_cast<float*>(smem + at.bias);
  float* ks_s = reinterpret_cast<float*>(smem + at.ks);
  float* vs_s = reinterpret_cast<float*>(smem + at.vs);
  float* p_s = reinterpret_cast<float*>(smem + at.p);  // [RMAX][SP]: s, then p
  float* part_s = reinterpret_cast<float*>(smem + at.part);  // [SNW][RMAX][HD]
  float* max_s = reinterpret_cast<float*>(smem + at.red);  // [SNW][RMAX]
  float* sum_s = max_s + SNW * RMAX;  // [SNW][RMAX]
  int* row_s = reinterpret_cast<int*>(smem + at.row);  // [SP]: slot -> pool row, or -1
  int* table_s = reinterpret_cast<int*>(smem + at.table);

  const int b = blockIdx.x / Hkv, g = blockIdx.x % Hkv;
  const int rep = H / Hkv, R = rep * T;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int page0 = layer_ix * NP;  // the wrapper keeps every pool row index below 2^31

  // 1. loads that depend on nothing: the lane's table row, the group's
  // query rows (row r = t * rep + i is head g * rep + i at token t; rows
  // from R on are zero-filled) and the lane's bias rows [T, S]
  const int* table = page_table + static_cast<long long>(b) * MP;
  for (int j = tid; j < MP; j += SNT) cp_async4(&table_s[j], table + j, true);
  for (int x = tid; x < RMAX * (HD / 8); x += SNT) {
    const int r = x / (HD / 8), c = (x % (HD / 8)) * 8;
    const bool ok = r < R;
    const int t = ok ? r / rep : 0, h = g * rep + (ok ? r % rep : 0);
    cp_async16(&q_s[r * HD + c], q + ((static_cast<long long>(b) * T + t) * H + h) * HD + c, ok);
  }
  const float* brow = bias + static_cast<long long>(b) * T * S;
  if ((T * S) % 4 == 0) {
    for (int x = tid; x < T * S / 4; x += SNT) cp_async16(&bias_s[4 * x], brow + 4 * x, true);
  } else {
    for (int x = tid; x < T * S; x += SNT) cp_async4(&bias_s[x], brow + x, true);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // 2. one burst: K rows and both scales (one commit group), then V rows
  // (a second), of every slot short_slot_row names; the rest of the SP
  // slots zero-filled. The NV pieces of a slot go to NV neighbouring
  // threads of one warp; the first decides the slot for all of them.
  for (int x = tid; x < SP * NV; x += SNT) {
    const int j = x / NV, p = x % NV;
    if (p == 0) {
      const int row = short_slot_row(table_s, bias_s, j, S, T, PS, Hkv, g, page0);
      row_s[j] = row;
      if (QUANT) {
        cp_async4(&ks_s[j], pk_scale + (row < 0 ? 0 : row), row >= 0);
        cp_async4(&vs_s[j], pv_scale + (row < 0 ? 0 : row), row >= 0);
      }
    }
    __syncwarp();
    const int row = row_s[j];
    cp_async16(&k_s[j * LDR + p], pk + (row < 0 ? 0 : static_cast<long long>(row) * HD + p * EPP), row >= 0);
  }
  cp_async_commit();
  for (int x = tid; x < SP * NV; x += SNT) {
    const int j = x / NV, p = x % NV;
    const int row = row_s[j];
    cp_async16(&v_s[j * LDR + p], pv + (row < 0 ? 0 : static_cast<long long>(row) * HD + p * EPP), row >= 0);
  }
  cp_async_commit();
  const int quarter = lane & (NQ - 1);  // the 16 channels of a slot this thread scores
  float qreg[QREG ? RMAX : 1][16];
  if constexpr (QREG) {
#pragma unroll
    for (int r = 0; r < RMAX; ++r) q16_to_float<HD>(q_s, r, quarter, qreg[r]);
  }

  // 3. scores once K is in: threads NQ i .. NQ i + NQ - 1 share a slot, 16
  // channels each; s = (q . k) * sm_scale * k_scale + bias, -inf on a slot
  // not read; each warp's row maxima go to max_s
  cp_async_wait_group<1>();
  __syncthreads();
  float mx[RMAX];
  int brow_s[RMAX];  // row r's bias row, bias_s + (r / rep) * S
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    mx[r] = neg_infinity();
    brow_s[r] = r < R ? (r / rep) * S : 0;
  }
  for (int x = tid; x < SP * NQ; x += SNT) {  // a whole warp takes each step (SP * NQ is a multiple of 64)
    const int j = x / NQ;
    const bool live = row_s[j] >= 0;
    float kf[16];
    k16_to_float(&k_s[j * LDR + quarter * (16 / EPP)], kf, KV());
    const float ks = QUANT ? ks_s[j] : 1.f;
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      float qf[16];
      if constexpr (QREG) {
#pragma unroll
        for (int i = 0; i < 16; ++i) qf[i] = qreg[r][i];
      } else {
        q16_to_float<HD>(q_s, r, quarter, qf);
      }
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) dot += qf[i] * kf[i];
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      if constexpr (NQ == 8) dot += __shfl_xor_sync(0xffffffffu, dot, 4);
      float sc = neg_infinity();
      if (live && r < R) sc = dot * sm_scale * ks + bias_s[brow_s[r] + j];
      if ((r % NQ) == quarter) p_s[r * SP + j] = sc;
      mx[r] = fmaxf(mx[r], sc);
    }
  }
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], o));
    if (lane == 0) max_s[warp * RMAX + r] = mx[r];
  }

  // 4. softmax over the lane's whole row: m from the warps' maxima, p =
  // exp(s - m) * v_scale in place, thread tid over slots tid and tid + SNT
  // (0 on a slot not read), each warp's sums of exp(s - m) to sum_s
  __syncthreads();
  float m[RMAX], l[RMAX];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    m[r] = max_s[r];
#pragma unroll
    for (int w = 1; w < SNW; ++w) m[r] = fmaxf(m[r], max_s[w * RMAX + r]);
    l[r] = 0.f;
  }
  for (int j = tid; j < SP; j += SNT) {
    const float vs = QUANT ? vs_s[j] : 1.f;
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      const float sc = p_s[r * SP + j];
      const float e = sc == neg_infinity() ? 0.f : __expf(sc - m[r]);
      p_s[r * SP + j] = e * vs;
      l[r] += e;
    }
  }
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
    if (lane == 0) sum_s[warp * RMAX + r] = l[r];
  }

  // 5. P.V once V is in: warp w takes slots [w * SP / 4, (w + 1) * SP / 4),
  // lane l channels 2l and 2l + 1 of every row; the warps' partials meet
  // in shared memory and are summed in warp order
  cp_async_wait_group<0>();
  __syncthreads();
  if constexpr (HD == 64) {
    float acc[RMAX][2];
#pragma unroll
    for (int r = 0; r < RMAX; ++r) acc[r][0] = acc[r][1] = 0.f;
    const int span = SP / SNW;  // a multiple of 4
    for (int j = warp * span; j < (warp + 1) * span; j += 4) {
      float v0[4], v1[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v_pair(reinterpret_cast<const KV*>(v_s + (j + u) * LDR) + 2 * lane, v0[u], v1[u]);
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        if (r < R) {
          const float4 pr = *reinterpret_cast<const float4*>(&p_s[r * SP + j]);
          acc[r][0] += pr.x * v0[0] + pr.y * v0[1] + pr.z * v0[2] + pr.w * v0[3];
          acc[r][1] += pr.x * v1[0] + pr.y * v1[1] + pr.z * v1[2] + pr.w * v1[3];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r < R) {
        *reinterpret_cast<float2*>(&part_s[(warp * RMAX + r) * HD + 2 * lane]) = make_float2(acc[r][0], acc[r][1]);
      }
    }
    __syncthreads();
    for (int x = tid; x < R * (HD / 2); x += SNT) {
      const int r = x / (HD / 2), c = (x % (HD / 2)) * 2;
      float o0 = 0.f, o1 = 0.f, lsum = 0.f;
#pragma unroll
      for (int w = 0; w < SNW; ++w) {
        const float2 pw = *reinterpret_cast<const float2*>(&part_s[(w * RMAX + r) * HD + c]);
        o0 += pw.x;
        o1 += pw.y;
        lsum += sum_s[w * RMAX + r];
      }
      const float lm = fmaxf(lsum, 1e-30f);
      const int t = r / rep, h = g * rep + r % rep;
      *reinterpret_cast<__nv_bfloat162*>(out + ((static_cast<long long>(b) * T + t) * H + h) * HD + c) =
          __floats2bfloat162_rn(o0 / lm, o1 / lm);
    }
  } else {
    // D = 128: thread c takes channel c of every row over all the slots
    // (the V scale rides p), and writes it
    const int ch = tid;
    float acc[RMAX];
#pragma unroll
    for (int r = 0; r < RMAX; ++r) acc[r] = 0.f;
    for (int j = 0; j < SP; j += 4) {
      float vv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) vv[u] = elem_to_float(reinterpret_cast<const KV*>(v_s + (j + u) * LDR)[ch]);
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        if (r < R) {
          const float4 pr = *reinterpret_cast<const float4*>(&p_s[r * SP + j]);
          acc[r] += pr.x * vv[0] + pr.y * vv[1] + pr.z * vv[2] + pr.w * vv[3];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r < R) {
        float lsum = 0.f;
#pragma unroll
        for (int w = 0; w < SNW; ++w) lsum += sum_s[w * RMAX + r];
        const int t = r / rep, h = g * rep + r % rep;
        out[((static_cast<long long>(b) * T + t) * H + h) * HD + ch] = __float2bfloat16_rn(acc[r] / fmaxf(lsum, 1e-30f));
      }
    }
  }
}

// raises the kernel's dynamic shared memory limit to its largest launch
// (T = RMAX, S = MP = SHORT_SLOTS) once per device; returns a CUDA error code
template <typename KV, int RMAX, int HD>
int short_prepare() {
  static unsigned long long done = 0;  // one bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && (done >> dev & 1ULL)) return 0;
  err = cudaFuncSetAttribute(paged_attention_short_kernel<KV, RMAX, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             short_smem<KV, RMAX, HD>(RMAX, SHORT_SLOTS, SHORT_SLOTS).total);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64) done |= 1ULL << dev;
  return 0;
}

template <typename KV>
int short_dispatch(int R, const void* q, const void* pk, const void* pv, const float* pks, const float* pvs,
                   const int* table, const float* bias, void* out, int B, int T, int H, int Hkv, int D, int NP,
                   int PS, int MP, int layer_ix, float sm_scale, cudaStream_t st) {
  return by_shape(R, D, [&](auto rows, auto hd) {
    constexpr int RMAX = decltype(rows)::value, HD = decltype(hd)::value;
    const int rc = short_prepare<KV, RMAX, HD>();
    if (rc != 0) return rc;
    paged_attention_short_kernel<KV, RMAX, HD><<<B * Hkv, SNT, short_smem<KV, RMAX, HD>(T, MP * PS, MP).total, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(pk), static_cast<const KV*>(pv), pks, pvs,
        table, bias, static_cast<__nv_bfloat16*>(out), T, H, Hkv, NP, PS, MP, layer_ix, sm_scale);
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename KV>
int short_occupancy(int R, int D, int T, int S, int MP, int* ctas_per_sm, int* smem_bytes) {
  return by_shape(R, D, [&](auto rows, auto hd) {
    constexpr int RMAX = decltype(rows)::value, HD = decltype(hd)::value;
    const int rc = short_prepare<KV, RMAX, HD>();
    if (rc != 0) return rc;
    *smem_bytes = short_smem<KV, RMAX, HD>(T, S, MP).total;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas_per_sm, paged_attention_short_kernel<KV, RMAX, HD>, SNT, *smem_bytes));
  });
}

template <typename KV>
int long_occupancy(int R, int D, int* ctas_per_sm) {
  return by_shape<true>(R, D, [&](auto rows, auto hd) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas_per_sm, paged_attention_kernel<KV, decltype(rows)::value, decltype(hd)::value>, NT, 0));
  });
}

}  // namespace

// All tensors contiguous. q/out [B,T,H,D] bf16; pk/pv [L,NP,PS,Hkv,D] int8
// (quant = 1, with pk_scale/pv_scale [L,NP,PS,Hkv] fp32) or bf16 (quant = 0,
// scales ignored); page_table [B,MP] int32; bias [B,1,T,MP*PS] fp32. Built
// for D in {64, 128} and (H / Hkv) * T <= 32. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for unsupported arguments.
extern "C" int paged_attention_bf16(const void* q, const void* pk, const void* pv,
                                    const float* pk_scale, const float* pv_scale,
                                    const int* page_table, const float* bias, void* out,
                                    int B, int T, int H, int Hkv, int D, int NP, int PS,
                                    int MP, int layer_ix, int quant, float sm_scale,
                                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((D != 64 && D != 128) || Hkv < 1 || H % Hkv || T < 1 || PS < 1 || MP < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int R = (H / Hkv) * T;
  if (R > 32 || (quant && (pk_scale == nullptr || pv_scale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (quant)
    return dispatch<int8_t>(R, q, pk, pv, pk_scale, pv_scale, page_table, bias, out, B, T, H,
                            Hkv, D, NP, PS, MP, layer_ix, sm_scale, st);
  return dispatch<__nv_bfloat16>(R, q, pk, pv, nullptr, nullptr, page_table, bias, out, B, T,
                                 H, Hkv, D, NP, PS, MP, layer_ix, sm_scale, st);
}

// The short route: the arguments of paged_attention_bf16, for tables of
// MP * PS <= 256 slots. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for unsupported arguments (a wider table included).
extern "C" int paged_attention_short_bf16(const void* q, const void* pk, const void* pv,
                                          const float* pk_scale, const float* pv_scale,
                                          const int* page_table, const float* bias, void* out,
                                          int B, int T, int H, int Hkv, int D, int NP, int PS,
                                          int MP, int layer_ix, int quant, float sm_scale,
                                          void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((D != 64 && D != 128) || Hkv < 1 || H % Hkv || T < 1 || PS < 1 || MP < 1 || B < 1 ||
      MP * PS > SHORT_SLOTS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int R = (H / Hkv) * T;
  if (R > 32 || (quant && (pk_scale == nullptr || pv_scale == nullptr)) ||
      (static_cast<long long>(layer_ix) + 1) * NP * PS * Hkv >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (quant)
    return short_dispatch<int8_t>(R, q, pk, pv, pk_scale, pv_scale, page_table, bias, out, B, T, H, Hkv, D,
                                  NP, PS, MP, layer_ix, sm_scale, st);
  return short_dispatch<__nv_bfloat16>(R, q, pk, pv, nullptr, nullptr, page_table, bias, out, B, T, H, Hkv,
                                       D, NP, PS, MP, layer_ix, sm_scale, st);
}

// What a launch at this shape gets on the current card: CTAs an SM, threads
// a CTA and dynamic shared memory. `short_route` selects the kernel.
extern "C" int paged_attention_occupancy(int short_route, int T, int H, int Hkv, int D, int PS, int MP, int quant,
                                         int* ctas_per_sm, int* threads, int* smem_bytes) {
  if ((D != 64 && D != 128) || Hkv < 1 || H % Hkv || T < 1 || PS < 1 || MP < 1 || (H / Hkv) * T > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const int R = (H / Hkv) * T, S = MP * PS;
  if (short_route) {
    if (S > SHORT_SLOTS) return static_cast<int>(cudaErrorInvalidValue);
    *threads = SNT;
    if (quant) return short_occupancy<int8_t>(R, D, T, S, MP, ctas_per_sm, smem_bytes);
    return short_occupancy<__nv_bfloat16>(R, D, T, S, MP, ctas_per_sm, smem_bytes);
  }
  *threads = NT;
  *smem_bytes = 0;
  if (quant) return long_occupancy<int8_t>(R, D, ctas_per_sm);
  return long_occupancy<__nv_bfloat16>(R, D, ctas_per_sm);
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
