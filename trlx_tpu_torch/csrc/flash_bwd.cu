// Flash-attention backward for Hopper (sm_90a), bf16 in, fp32 accumulation,
// in two routes chosen by the wrapper from the shape:
// - the fused route, T, S <= 128: flash_bwd_fused_kernel, ONE launch that
//   gives dq, dk and dv;
// - the long route, past 128: flash_bwd_dq_kernel, then flash_bwd_dkv_kernel.
//
// Replaces: trlx_tpu/ops/flash_attention.py : _flash_backward, i.e. its two
// pallas_calls (:314 and :347), _dq_kernel (:192) and _dkv_kernel (:231).
// Both routes compute its function.
//
// Given the forward's inputs q [B,H,T,D], k/v [B,Hkv,S,D], key_mask [B,S],
// its softmax stats m, l [B*H,T] (fp32) and the output gradient do [B,H,T,D]:
//   s[t,j]  = (q[t] . k[j]) * sm_scale, replaced by -1e30 where (t, j) is
//             masked (key_mask == 0, or causal and q_offset + t < j),
//   p[t,j]  = exp(s - m[t]) / max(l[t], 1e-30),
//   dp[t,j] = do[t] . v[j],
//   delta[t] = sum over the row's valid pairs of p dp (fp32),
//   ds[t,j] = valid ? p (dp - delta[t]) sm_scale : 0,
//   dq[t]   = sum_j ds[t,j] k[j],
//   dk[j]   = sum over the heads of j's GQA group and over t of ds[t,j] q[t],
//   dv[j]   = the same sum of p[t,j] do[t].
// A fully masked row (a left-pad query: m = -1e30) has p = 1/l at EVERY slot,
// causal-future slots included, so it adds do/l to dv at every slot; its ds
// is zero, so it adds nothing to dq or dk. Slots past the end of S and rows
// past the end of T are not slots or rows: they take and give no weight.
//
// What bounds it on this card: per (b, h) five products of 2*D flops for
// each weighed (t, j) pair (S, dP, dQ, dK, dV) over 2 bytes per element of
// q, k, v, do, dq, dk, dv: at the training shapes (T = S = 64..72, D = 64,
// causal, left-padded) some 20 flops a byte (chip_smoke.py's
// flash_bwd_work), far below the H100's ~295 flop/byte ridge, so the
// function is bound by its bytes, and at these small sizes in practice by
// latency: launches, the dependency between them, and the chain of loads
// before the first product.
//
// Precision (both routes). A row's ds sum to zero, so dq = sum_j ds k_j
// does not see the part of the keys common to all slots, and dk and the key
// projection's gradient likewise cancel along the queries' common part. In
// GPT-2 that common part is large against what varies, so an error that
// moves a row's ds sum off zero is multiplied by it. Two such errors, both
// avoided here:
// - delta = rowsum(do * out), as the TPU kernel forms it, uses the bf16
//   out, whose rounding shifts every ds of the row alike; delta summed from
//   the same p and dp that form ds keeps the row sum at zero;
// - ds rounded to bf16 for the tensor cores: each product takes ds as two
//   bf16 parts, hi = bf16(ds) and lo = bf16(ds - hi), so it carries 16
//   bits, as close to fp32 as the plain path's fp32 ds.
// The first version of the long route had both, and the q/k projection
// gradients of GPT-2 small came out up to 8x further from fp32 than the
// plain bf16 path's (chip_smoke.py train_reference on an H100).
//
// The fused route (flash_bwd_fused_kernel), one CTA per (b, kv head)
// holding the whole ceil16(T) x ceil16(S) tile:
// 1. The operands enter shared memory once, by cp.async with zero fill:
//    K and V of the kv head (only slots some row attends are read), Q and
//    dO of each head of the GQA group in turn (dO of every row: a fully
//    masked row feeds dv). The dynamic shared memory is sized from
//    ceil16(T) and ceil16(S), and registers are bounded per instantiation
//    (the kernel is instantiated per ceil16(S) / 16), so that three CTAs
//    run on an SM at GPT-2's train shape (T = S = 64): its B32 x H12 = 384
//    CTAs fit in one wave of 396, as T5's 144 cross-attention CTAs (T = 65
//    over S = 32) do.
// 2. Each product once. The query-major phase has one warp per 16-row
//    strip: it computes s and dp over the strip's whole row in registers,
//    sums delta from them in fp32, forms ds, takes dq = ds K and leaves p
//    (bf16) and ds (bf16 hi and lo) in shared memory. The key-major phase,
//    one warp per 16-slot strip, takes dv += p^T dO and dk += ds^T Q from
//    there. Every fragment comes by ldmatrix (.trans for the transposed
//    operands). No s or dp is recomputed and delta never leaves the CTA.
// 3. Causal-future skips: 8-slot tiles wholly in the causal future of
//    every row of a strip take no S or dP product and no dQ product; a 16 x
//    16 block of the key-major phase wholly in its rows' causal future
//    takes no dK product, and no dV product unless a row of its query
//    strip is fully masked (the long route's tile rule, per strip).
// 4. GQA: the group's heads are walked in order inside the CTA, and dk, dv
//    are summed over them with no atomics, so the result has the same bits
//    run to run. A head's key-major sums are added to the CTA's own fp32
//    partial (scratch in device memory, in mma-fragment order, read back
//    through L2 by the thread that wrote it): kept in shared memory it
//    would not fit beside the tile at T = S = 128 (244,256 bytes against
//    the 232,448 a CTA may have), and kept in registers it would hold 64
//    more a thread across the query-major phase, which already takes the
//    168 that the bounds of step 1 allow. One head a group (GPT-2) touches
//    no scratch.
// Every global load that feeds a product is unconditional, at a clamped
// address, and its value replaced after: a load under a branch does not
// overlap the next one.
// What the fused route removes, against the pair it replaces at T, S <=
// 128 (0.0618 ms against SDPA's backward at 0.0411 on an H100 at GPT-2's
// train shape; PERF.md): the second launch and its wait for the first,
// two of the three computations of S = Q K^T and dP = dO V^T (the dq
// kernel walks K/V twice, for delta and then for ds, and the dk/dv kernel a
// third time), the staging of K/V and Q/dO through registers under a
// branch, and the scalar fragment loads. What still holds it back at the
// train shape (H100, the kernel cut after each stage by
// trlx_tpu_torch/tools/bwd_stages.py; PERF.md): the launch, then the
// operand loads, the two phases and the writes one after the other, every
// CTA of the one wave in step, so no CTA's loads overlap another's work.
//
// The long route, past 128: two kernels and no atomics, as in the TPU design.
// - dq: one CTA per (b*h, 64-row query tile), its q and do rows held in
//   registers as mma fragments; K/V stream through shared memory in 64-slot
//   tiles. S = Q K^T and dP = dO V^T run on mma.sync m16n8k16 (bf16 in, fp32
//   accumulate), 16 slots at a time. A first pass over the tiles sums
//   delta = sum_j p dp in fp32 and writes it out for the dk/dv kernel; the
//   second forms dS in registers and multiplies it into dQ += dS K. Tiles
//   wholly in every row's causal future are skipped (they carry ds = 0), and
//   K/V rows of masked or causal-future slots are never read.
// - dk/dv: one CTA per (b*hkv, 64-slot key tile), its k and v rows held in
//   registers; it loops over the query tiles of ALL heads of the GQA group,
//   so the group sum happens in registers (the TPU kernel's rep*T rows).
//   It works on the transposed tile (keys x queries): S^T = K Q^T,
//   dP^T = V dO^T, dV += P^T dO (P in bf16, as the plain path's probs),
//   dK += dS^T Q (dS as hi + lo). A query tile wholly before
//   the key tile is skipped only when no row of it is fully masked
//   (__syncthreads_or over the tile's m), as the forward's tile skip.
// Registers: up to 255 a thread (two CTAs an SM), so the fragments and both
// fp32 accumulators stay out of local memory.
// TMA, wgmma and pipelining are later work for both routes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;  // query rows per tile: 4 warps x 16 rows
constexpr int BK = 64;  // key slots per tile
constexpr int NTHREADS = 128;
constexpr float NEG_INF = -1e30f;

template <int D>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const int* __restrict__ key_mask,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ m_in, const float* __restrict__ l_in,
                    float* __restrict__ delta_out,
                    __nv_bfloat16* __restrict__ dq,
                    int H, int Hkv, int T, int S,
                    long long q_sb, long long q_sh, long long q_st,
                    long long k_sb, long long k_sh, long long k_ss,
                    long long v_sb, long long v_sh, long long v_ss,
                    long long do_sb, long long do_sh, long long do_st,
                    long long dq_sb, long long dq_sh, long long dq_st,
                    int causal, int q_offset, float sm_scale) {
  constexpr int KSTEPS = D / 16;
  constexpr int NT_D = D / 8;
  constexpr int LDS = D + 8;  // padded shared row, in bf16 elements

  __shared__ __align__(16) __nv_bfloat16 k_s[BK * LDS];
  __shared__ __align__(16) __nv_bfloat16 v_s[BK * LDS];
  __shared__ int valid_s[BK];  // 1 attendable slot, 0 masked or past the end

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.y * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8

  const __nv_bfloat16* kb = k + b * k_sb + hk * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + hk * v_sh;
  const int* mb = key_mask + (long long)b * S;

  uint32_t qf[KSTEPS][4], dof[KSTEPS][4];
  load_a_rows<D>(qf, q + b * q_sb + h * q_sh, q_st, r0, r0 < T, r0 + 8 < T, c);
  load_a_rows<D>(dof, dout + b * do_sb + h * do_sh, do_st, r0, r0 < T, r0 + 8 < T, c);

  float m_r[2], linv[2], dlt[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + i * 8;
    const bool ok = row < T;
    m_r[i] = ok ? m_in[(long long)bh * T + row] : 0.f;
    linv[i] = ok ? 1.f / fmaxf(l_in[(long long)bh * T + row], 1e-30f) : 0.f;
  }

  float acc[NT_D][4];
#pragma unroll
  for (int n = 0; n < NT_D; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int row_last = min(q0 + BQ, T) - 1;
  const int n_tiles = (S + BK - 1) / BK;
  // pass 0 sums delta = sum_j p dp over the row's valid pairs; pass 1 forms
  // ds with it and accumulates dq
  for (int pass = 0; pass < 2; ++pass) {
  if (pass == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // the row's 4 lanes hold 2 columns a tile each
      dlt[i] += __shfl_xor_sync(0xffffffffu, dlt[i], 1);
      dlt[i] += __shfl_xor_sync(0xffffffffu, dlt[i], 2);
      const int row = r0 + i * 8;
      if (c == 0 && row < T) delta_out[(long long)bh * T + row] = dlt[i];
    }
  }
  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * BK;
    // every slot from here on lies in every row's causal future: p dp and ds
    // add nothing there, fully masked rows included (uniform for the CTA)
    if (causal && kv0 > q_offset + row_last) break;
    __syncthreads();  // the previous tile is consumed
    constexpr int VECS = D / 8;  // 16-byte vectors per row
    for (int i = threadIdx.x; i < BK * VECS; i += NTHREADS) {
      const int row = i / VECS, col = (i % VECS) * 8;
      const int slot = kv0 + row;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      // only attendable slots inside some row's causal window carry ds != 0
      if (slot < S && mb[slot] > 0 && !(causal && slot > q_offset + row_last)) {
        kx = *reinterpret_cast<const uint4*>(kb + slot * k_ss + col);
        vx = *reinterpret_cast<const uint4*>(vb + slot * v_ss + col);
      }
      *reinterpret_cast<uint4*>(&k_s[row * LDS + col]) = kx;
      *reinterpret_cast<uint4*>(&v_s[row * LDS + col]) = vx;
    }
    if (threadIdx.x < BK) {
      const int slot = kv0 + threadIdx.x;
      valid_s[threadIdx.x] = (slot < S && mb[slot] > 0) ? 1 : 0;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {  // 16 slots at a time
      float s[2][4], dp[2][4];
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nn][e] = dp[nn][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          uint32_t b0, b1;
          b_from_cols<LDS>(k_s, ks, 2 * kk + nn, g, c, b0, b1);
          mma_bf16(s[nn], qf[ks], b0, b1);
          b_from_cols<LDS>(v_s, ks, 2 * kk + nn, g, c, b0, b1);
          mma_bf16(dp[nn], dof[ks], b0, b1);
        }
      }
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = (2 * kk + nn) * 8 + c * 2 + (e & 1);
          const int i = e >> 1;
          const int row = r0 + i * 8;
          const bool ok = valid_s[col] && row < T && !(causal && q_offset + row < kv0 + col);
          const float p = ok ? __expf(s[nn][e] * sm_scale - m_r[i]) * linv[i] : 0.f;
          if (pass == 0) {
            dlt[i] += p * dp[nn][e];
          } else {
            s[nn][e] = ok ? p * (dp[nn][e] - dlt[i]) * sm_scale : 0.f;  // ds
          }
        }
      }
      if (pass == 1) {
        uint32_t hi[4], lo[4];
        pack_acc_split(hi, lo, s[0], s[1]);
#pragma unroll
        for (int n = 0; n < NT_D; ++n) {
          uint32_t b0, b1;
          b_from_rows<LDS>(k_s, kk, n, g, c, b0, b1);
          mma_bf16(acc[n], hi, b0, b1);
          mma_bf16(acc[n], lo, b0, b1);
        }
      }
    }
  }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + i * 8;
    if (row >= T) continue;
    __nv_bfloat16* orow = dq + b * dq_sb + h * dq_sh + row * dq_st;
#pragma unroll
    for (int n = 0; n < NT_D; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8 + c * 2) =
          pack_f32(acc[n][2 * i], acc[n][2 * i + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ key_mask,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ m_in, const float* __restrict__ l_in,
                     const float* __restrict__ delta_in,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                     int H, int Hkv, int T, int S,
                     long long q_sb, long long q_sh, long long q_st,
                     long long k_sb, long long k_sh, long long k_ss,
                     long long v_sb, long long v_sh, long long v_ss,
                     long long do_sb, long long do_sh, long long do_st,
                     long long dk_sb, long long dk_sh, long long dk_ss,
                     long long dv_sb, long long dv_sh, long long dv_ss,
                     int causal, int q_offset, float sm_scale) {
  constexpr int KSTEPS = D / 16;
  constexpr int NT_D = D / 8;
  constexpr int LDS = D + 8;

  __shared__ __align__(16) __nv_bfloat16 q_s[BQ * LDS];
  __shared__ __align__(16) __nv_bfloat16 do_s[BQ * LDS];
  __shared__ float m_s[BQ], linv_s[BQ], dlt_s[BQ];
  __shared__ int row_s[BQ];  // 1 a row of T, 0 past its end

  const int bhk = blockIdx.x;
  const int b = bhk / Hkv, hk = bhk % Hkv;
  const int rep = H / Hkv;
  const int kv0 = blockIdx.y * BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int j0 = kv0 + warp * 16 + g;  // this thread's key slots: j0 and j0 + 8
  const int* mb = key_mask + (long long)b * S;

  // a masked key's s is -1e30 and its ds zero whatever its K and V: only
  // attendable keys are read
  bool kvalid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int slot = j0 + i * 8;
    kvalid[i] = slot < S && mb[slot] > 0;
  }
  uint32_t kf[KSTEPS][4], vf[KSTEPS][4];
  load_a_rows<D>(kf, k + b * k_sb + hk * k_sh, k_ss, j0, kvalid[0], kvalid[1], c);
  load_a_rows<D>(vf, v + b * v_sb + hk * v_sh, v_ss, j0, kvalid[0], kvalid[1], c);

  float dk_acc[NT_D][4], dv_acc[NT_D][4];
#pragma unroll
  for (int n = 0; n < NT_D; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const int n_qt = (T + BQ - 1) / BQ;
  for (int r = 0; r < rep; ++r) {  // the heads of this kv head's group
    const int h = hk * rep + r;
    const long long bh = (long long)b * H + h;
    const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
    const __nv_bfloat16* dob = dout + b * do_sb + h * do_sh;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int t0 = qt * BQ;
      const int t_last = min(t0 + BQ, T) - 1;
      __syncthreads();  // the previous tile is consumed
      if (threadIdx.x < BQ) {
        const int t = t0 + threadIdx.x;
        const bool ok = t < T;
        m_s[threadIdx.x] = ok ? m_in[bh * T + t] : 0.f;
        linv_s[threadIdx.x] = ok ? 1.f / fmaxf(l_in[bh * T + t], 1e-30f) : 0.f;
        dlt_s[threadIdx.x] = ok ? delta_in[bh * T + t] : 0.f;
        row_s[threadIdx.x] = ok ? 1 : 0;
      }
      __syncthreads();
      if (causal && q_offset + t_last < kv0) {
        // every pair of this tile lies in its row's causal future: only a
        // fully masked row (uniform p = 1/l over all S) still weighs the keys
        const int need = threadIdx.x < BQ && row_s[threadIdx.x] &&
                         m_s[threadIdx.x] == NEG_INF;
        if (!__syncthreads_or(need)) continue;
      }
      constexpr int VECS = D / 8;
      for (int i = threadIdx.x; i < BQ * VECS; i += NTHREADS) {
        const int row = i / VECS, col = (i % VECS) * 8;
        const int t = t0 + row;
        uint4 qx = make_uint4(0u, 0u, 0u, 0u), dx = qx;
        if (t < T) {
          qx = *reinterpret_cast<const uint4*>(qb + t * q_st + col);
          dx = *reinterpret_cast<const uint4*>(dob + t * do_st + col);
        }
        *reinterpret_cast<uint4*>(&q_s[row * LDS + col]) = qx;
        *reinterpret_cast<uint4*>(&do_s[row * LDS + col]) = dx;
      }
      __syncthreads();

#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {  // 16 query rows at a time
        float st[2][4], dpt[2][4];
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[nn][e] = dpt[nn][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
          for (int nn = 0; nn < 2; ++nn) {
            uint32_t b0, b1;
            b_from_cols<LDS>(q_s, ks, 2 * kk + nn, g, c, b0, b1);
            mma_bf16(st[nn], kf[ks], b0, b1);
            b_from_cols<LDS>(do_s, ks, 2 * kk + nn, g, c, b0, b1);
            mma_bf16(dpt[nn], vf[ks], b0, b1);
          }
        }
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = (2 * kk + nn) * 8 + c * 2 + (e & 1);  // row of the tile
            const int i = e >> 1;
            const int slot = j0 + i * 8;
            float p = 0.f, ds = 0.f;
            if (row_s[col] && slot < S) {
              const bool ok = kvalid[i] && !(causal && q_offset + t0 + col < slot);
              const float x = ok ? st[nn][e] * sm_scale : NEG_INF;
              p = __expf(x - m_s[col]) * linv_s[col];
              ds = ok ? p * (dpt[nn][e] - dlt_s[col]) * sm_scale : 0.f;
            }
            st[nn][e] = p;
            dpt[nn][e] = ds;
          }
        }
        uint32_t pa[4], dhi[4], dlo[4];
        pack_acc(pa, st[0], st[1]);
        pack_acc_split(dhi, dlo, dpt[0], dpt[1]);
#pragma unroll
        for (int n = 0; n < NT_D; ++n) {
          uint32_t b0, b1;
          b_from_rows<LDS>(do_s, kk, n, g, c, b0, b1);
          mma_bf16(dv_acc[n], pa, b0, b1);
          b_from_rows<LDS>(q_s, kk, n, g, c, b0, b1);
          mma_bf16(dk_acc[n], dhi, b0, b1);
          mma_bf16(dk_acc[n], dlo, b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int slot = j0 + i * 8;
    if (slot >= S) continue;
    __nv_bfloat16* krow = dk + b * dk_sb + hk * dk_sh + slot * dk_ss;
    __nv_bfloat16* vrow = dv + b * dv_sb + hk * dv_sh + slot * dv_ss;
#pragma unroll
    for (int n = 0; n < NT_D; ++n) {
      *reinterpret_cast<uint32_t*>(krow + n * 8 + c * 2) =
          pack_f32(dk_acc[n][2 * i], dk_acc[n][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(vrow + n * 8 + c * 2) =
          pack_f32(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// The fused route
// ---------------------------------------------------------------------------

constexpr int FUSED_MAX = 128;     // the longest T or S the fused kernel takes
constexpr int FUSED_LDS = 64 + 8;  // padded Q / dO / K / V row, bf16 elements (D = 64)

// warps of the fused kernel: one per 16-slot key strip, at least four
__host__ __device__ constexpr int fused_warps(int nk) { return nk > 4 ? nk : 4; }

// dynamic shared memory of the fused kernel for tp = ceil16(T), sp =
// ceil16(S): q, do [tp][72], k, v [sp][72], p, ds hi, ds lo [tp][sp + 8]
// (bf16), the slots' flags [sp] and the strips' fully-masked flags [tp / 16]
// (int); every bf16 region starts on a 16-byte boundary
inline int fused_smem_bytes(int tp, int sp) {
  return 2 * (2 * tp + 2 * sp) * FUSED_LDS + 2 * 3 * tp * (sp + 8) + 4 * sp + 4 * (tp / 16);
}

// rows [0, tp) of one head's [T, 64] bf16 rows into a [tp][FUSED_LDS] tile,
// by cp.async, zero-filled (nothing read) at rows past T
template <int NTH>
__device__ __forceinline__ void rows_async(bf16* dst_s, const bf16* src, long long stride, int tp, int T,
                                           int tid) {
  constexpr int VECS = 64 / 8;  // 16-byte vectors per row
  for (int i = tid; i < tp * VECS; i += NTH) {
    const int row = i / VECS, col = (i % VECS) * 8;
    const bool ok = row < T;
    cp_async16(&dst_s[row * FUSED_LDS + col], src + (ok ? row * stride + col : 0), ok);
  }
}

// One CTA per (b, kv head) of fused_warps(NK) warps; NK = ceil16(S) / 16
// sizes the strips' registers. Registers are bounded so that three CTAs of
// four warps share an SM up to NK = 4 (168 a thread: each of the SM's four
// register banks of 16K holds three such warps), two CTAs of five warps at
// NK = 5, and one CTA past that.
template <int NK>
__global__ void __launch_bounds__(NK == 5 ? 192 : (NK > 4 ? 32 * NK : 128), NK <= 4 ? 3 : (NK == 5 ? 2 : 1))
flash_bwd_fused_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const int* __restrict__ key_mask,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ m_in, const float* __restrict__ l_in,
                       bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                       float* __restrict__ dkv_part,
                       int H, int Hkv, int T, int S,
                       long long q_sb, long long q_sh, long long q_st,
                       long long k_sb, long long k_sh, long long k_ss,
                       long long v_sb, long long v_sh, long long v_ss,
                       long long do_sb, long long do_sh, long long do_st,
                       long long dq_sb, long long dq_sh, long long dq_st,
                       long long dk_sb, long long dk_sh, long long dk_ss,
                       long long dv_sb, long long dv_sh, long long dv_ss,
                       int causal, int q_offset, float sm_scale) {
  constexpr int D = 64;
  constexpr int KSTEPS = D / 16;
  constexpr int NT_D = D / 8;
  constexpr int LDS = FUSED_LDS;
  constexpr int SP = NK * 16;
  constexpr int LDP = SP + 8;  // padded p / ds row
  constexpr int NT_S = 2 * NK;  // 8-slot tiles of a strip's row
  constexpr int NWARPS = fused_warps(NK);
  constexpr int NTHREADS = 32 * NWARPS;

  extern __shared__ __align__(16) unsigned char smem[];
  const int TP = (T + 15) & ~15;
  const int n_strips = TP / 16;
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + TP * LDS;
  bf16* k_s = do_s + TP * LDS;
  bf16* v_s = k_s + SP * LDS;
  bf16* p_s = v_s + SP * LDS;
  bf16* dhi_s = p_s + TP * LDP;
  bf16* dlo_s = dhi_s + TP * LDP;
  int* valid_s = reinterpret_cast<int*>(dlo_s + TP * LDP);  // 1 attendable, 0 masked, -1 past S
  int* dead_s = valid_s + SP;  // 1 where the strip holds a fully masked row

  const int bhk = blockIdx.x;
  const int b = bhk / Hkv, hk = bhk % Hkv;
  const int rep = H / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int* mb = key_mask + (long long)b * S;
  // the last slot that some row's causal window reaches
  const int kv_last = causal ? min(S - 1, q_offset + T - 1) : S - 1;

  // 1. the operands into shared memory by cp.async: Q and dO of the group's
  // first head, the key flags meanwhile, then K and V of the slots some row
  // attends (zero-filled elsewhere: a masked slot's s is -1e30 and its ds
  // zero whatever K and V hold)
  rows_async<NTHREADS>(q_s, q + b * q_sb + hk * rep * q_sh, q_st, TP, T, tid);
  rows_async<NTHREADS>(do_s, dout + b * do_sb + hk * rep * do_sh, do_st, TP, T, tid);
  for (int i = tid; i < SP; i += NTHREADS) {
    const int mk = __ldg(mb + min(i, S - 1));
    valid_s[i] = i < S ? (mk > 0 ? 1 : 0) : -1;
  }
  __syncthreads();  // valid_s
  {
    const bf16* kb = k + b * k_sb + hk * k_sh;
    const bf16* vb = v + b * v_sb + hk * v_sh;
    constexpr int VECS = D / 8;
    for (int i = tid; i < SP * VECS; i += NTHREADS) {
      const int row = i / VECS, col = (i % VECS) * 8;
      const bool ok = valid_s[row] > 0 && row <= kv_last;
      cp_async16(&k_s[row * LDS + col], kb + (ok ? row * k_ss + col : 0), ok);
      cp_async16(&v_s[row * LDS + col], vb + (ok ? row * v_ss + col : 0), ok);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  for (int r = 0; r < rep; ++r) {  // the heads of this kv head's group, in order
    const int h = hk * rep + r;
    const long long bh = (long long)b * H + h;
    if (r > 0) {
      __syncthreads();  // the previous head's key-major phase has read q_s, do_s, p and ds
      rows_async<NTHREADS>(q_s, q + b * q_sb + h * q_sh, q_st, TP, T, tid);
      rows_async<NTHREADS>(do_s, dout + b * do_sb + h * do_sh, do_st, TP, T, tid);
      cp_async_wait_all();
      __syncthreads();
    }

    // 2a. query-major: a warp per 16-row strip over the whole row of S slots
    for (int st = warp; st < n_strips; st += NWARPS) {
      const int r0 = st * 16 + g;  // this thread's rows: r0 and r0 + 8
      // 8-slot tiles from n_live on lie in the causal future of every row
      // of the strip: p and ds are zero there (p_s takes a fully masked
      // row's 1/l all the same)
      int n_live = NT_S;
      if (causal) {
        const int lim = q_offset + min(st * 16 + 15, T - 1);
        n_live = lim < 0 ? 0 : min(lim / 8 + 1, NT_S);
      }
      float m_r[2], linv[2], dlt[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r0 + i * 8;
        const long long at = bh * T + min(row, T - 1);
        const float mv = __ldg(m_in + at), lv = __ldg(l_in + at);
        m_r[i] = row < T ? mv : 0.f;
        linv[i] = row < T ? 1.f / fmaxf(lv, 1e-30f) : 0.f;
      }
      float s[NT_S][4], dp[NT_S][4];
#pragma unroll
      for (int n = 0; n < NT_S; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t qa[4], da[4];
        ldm_a<LDS>(qa, q_s, st * 16, ks, lane);
        ldm_a<LDS>(da, do_s, st * 16, ks, lane);
#pragma unroll
        for (int n = 0; n < NT_S; n += 2) {
          if (n < n_live) {
            uint32_t kf[4], vf[4];
            ldm_b_cols<LDS>(kf, k_s, ks, n, lane);
            ldm_b_cols<LDS>(vf, v_s, ks, n, lane);
            mma_bf16(s[n], qa, kf[0], kf[1]);
            mma_bf16(s[n + 1], qa, kf[2], kf[3]);
            mma_bf16(dp[n], da, vf[0], vf[1]);
            mma_bf16(dp[n + 1], da, vf[2], vf[3]);
          }
        }
      }

      // p on the valid pairs (zero elsewhere) replaces s, and delta sums
      // p dp; p_s takes the weights dv needs, which for a row that attends
      // no slot are 1/l at every slot of S
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = r0 + i * 8;
          float pv[2];
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int e = 2 * i + x;
            const int col = n * 8 + c * 2 + x;
            const int flag = valid_s[col];
            const bool ok = flag > 0 && row < T && !(causal && q_offset + row < col);
            const float p = ok ? __expf(s[n][e] * sm_scale - m_r[i]) * linv[i] : 0.f;
            dlt[i] += p * dp[n][e];
            s[n][e] = p;
            pv[x] = (m_r[i] == NEG_INF && flag >= 0 && row < T) ? linv[i] : p;
          }
          *reinterpret_cast<uint32_t*>(&p_s[row * LDP + n * 8 + c * 2]) = pack_f32(pv[0], pv[1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // the row's 4 lanes hold 2 columns a tile each
        dlt[i] += __shfl_xor_sync(0xffffffffu, dlt[i], 1);
        dlt[i] += __shfl_xor_sync(0xffffffffu, dlt[i], 2);
      }
      // ds = p (dp - delta) sm_scale, zero where p is: into s and, as bf16
      // hi and lo, into shared memory for the key-major phase
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float x0 = s[n][2 * i] * (dp[n][2 * i] - dlt[i]) * sm_scale;
          const float x1 = s[n][2 * i + 1] * (dp[n][2 * i + 1] - dlt[i]) * sm_scale;
          s[n][2 * i] = x0;
          s[n][2 * i + 1] = x1;
          const int at = (r0 + i * 8) * LDP + n * 8 + c * 2;
          *reinterpret_cast<uint32_t*>(&dhi_s[at]) = pack_f32(x0, x1);
          *reinterpret_cast<uint32_t*>(&dlo_s[at]) = pack_f32(bf16_rest(x0), bf16_rest(x1));
        }
      }
      // dq = ds K over the strip's row
      float acc[NT_D][4];
#pragma unroll
      for (int n = 0; n < NT_D; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        if (2 * kk < n_live) {
          uint32_t hi[4], lo[4];
          pack_acc_split(hi, lo, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
          for (int n = 0; n < NT_D; n += 2) {
            uint32_t kf[4];
            ldm_b_rows<LDS>(kf, k_s, kk, n, lane);
            mma_bf16(acc[n], hi, kf[0], kf[1]);
            mma_bf16(acc[n], lo, kf[0], kf[1]);
            mma_bf16(acc[n + 1], hi, kf[2], kf[3]);
            mma_bf16(acc[n + 1], lo, kf[2], kf[3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r0 + i * 8;
        if (row >= T) continue;
        bf16* orow = dq + b * dq_sb + h * dq_sh + row * dq_st;
#pragma unroll
        for (int n = 0; n < NT_D; ++n)
          *reinterpret_cast<uint32_t*>(orow + n * 8 + c * 2) = pack_f32(acc[n][2 * i], acc[n][2 * i + 1]);
      }
      const bool dead = (m_r[0] == NEG_INF && r0 < T) || (m_r[1] == NEG_INF && r0 + 8 < T);
      const unsigned any_dead = __ballot_sync(0xffffffffu, dead);
      if (lane == 0) dead_s[st] = any_dead != 0u;
    }
    __syncthreads();  // p, ds and the strips' flags are in shared memory

    // 2b. key-major: a warp per 16-slot strip; dv += p^T dO, dk += ds^T Q
    if (warp < NK) {
      const int j0 = warp * 16;
      float dk_acc[NT_D][4], dv_acc[NT_D][4];
#pragma unroll
      for (int n = 0; n < NT_D; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
      for (int kt = 0; kt < n_strips; ++kt) {
        // the 16 x 16 block lies in the causal future of every row of query
        // strip kt: ds is zero there, and p too unless a row is fully masked
        const bool future = causal && j0 > q_offset + min(kt * 16 + 15, T - 1);
        if (!future || dead_s[kt]) {
          uint32_t pa[4];
          ldm_a_trans<LDP>(pa, p_s, j0, kt, lane);
#pragma unroll
          for (int n = 0; n < NT_D; n += 2) {
            uint32_t of[4];
            ldm_b_rows<LDS>(of, do_s, kt, n, lane);
            mma_bf16(dv_acc[n], pa, of[0], of[1]);
            mma_bf16(dv_acc[n + 1], pa, of[2], of[3]);
          }
        }
        if (!future) {
          uint32_t dh[4], dl[4];
          ldm_a_trans<LDP>(dh, dhi_s, j0, kt, lane);
          ldm_a_trans<LDP>(dl, dlo_s, j0, kt, lane);
#pragma unroll
          for (int n = 0; n < NT_D; n += 2) {
            uint32_t qf[4];
            ldm_b_rows<LDS>(qf, q_s, kt, n, lane);
            mma_bf16(dk_acc[n], dh, qf[0], qf[1]);
            mma_bf16(dk_acc[n], dl, qf[0], qf[1]);
            mma_bf16(dk_acc[n + 1], dh, qf[2], qf[3]);
            mma_bf16(dk_acc[n + 1], dl, qf[2], qf[3]);
          }
        }
      }
      // GQA: the group's running sum, this thread's fragments of this CTA's
      // fp32 partial (dk's 32 values, then dv's), lane-contiguous
      float* part = dkv_part + ((long long)bhk * NK + warp) * (2 * NT_D * 4 * 32) + lane;
      if (r > 0) {
#pragma unroll
        for (int n = 0; n < NT_D; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dk_acc[n][e] += __ldcg(part + (n * 4 + e) * 32);
            dv_acc[n][e] += __ldcg(part + ((NT_D + n) * 4 + e) * 32);
          }
      }
      if (r + 1 < rep) {
#pragma unroll
        for (int n = 0; n < NT_D; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            __stcg(part + (n * 4 + e) * 32, dk_acc[n][e]);
            __stcg(part + ((NT_D + n) * 4 + e) * 32, dv_acc[n][e]);
          }
      } else {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int slot = j0 + g + i * 8;
          if (slot >= S) continue;
          bf16* krow = dk + b * dk_sb + hk * dk_sh + slot * dk_ss;
          bf16* vrow = dv + b * dv_sb + hk * dv_sh + slot * dv_ss;
#pragma unroll
          for (int n = 0; n < NT_D; ++n) {
            *reinterpret_cast<uint32_t*>(krow + n * 8 + c * 2) = pack_f32(dk_acc[n][2 * i], dk_acc[n][2 * i + 1]);
            *reinterpret_cast<uint32_t*>(vrow + n * 8 + c * 2) = pack_f32(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
          }
        }
      }
    }
  }
}

// sets the kernel's dynamic shared memory limit (its 128-row footprint) once
// per device; returns a CUDA error code
template <int NK>
int fused_prepare() {
  static unsigned long long done = 0;  // one bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && (done >> dev & 1ULL)) return 0;
  err = cudaFuncSetAttribute(flash_bwd_fused_kernel<NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             fused_smem_bytes(FUSED_MAX, NK * 16));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64) done |= 1ULL << dev;
  return 0;
}

template <int NK>
int fused_launch(const void* q, const void* k, const void* v, const int* key_mask, const void* dout,
                 const float* m, const float* l, void* dq, void* dk, void* dv, float* dkv_part, int B, int H,
                 int Hkv, int T, int S, const long long* st, int causal, int q_offset, float sm_scale,
                 cudaStream_t stream) {
  const int rc = fused_prepare<NK>();
  if (rc != 0) return rc;
  const int tp = (T + 15) & ~15;
  flash_bwd_fused_kernel<NK><<<B * Hkv, 32 * fused_warps(NK), fused_smem_bytes(tp, NK * 16), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), key_mask,
      static_cast<const bf16*>(dout), m, l, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), dkv_part, H, Hkv, T, S, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], st[12], st[13], st[14], st[15], st[16], st[17], st[18], st[19], st[20],
      causal, q_offset, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int NK>
int fused_occupancy(int T, int* ctas_per_sm, int* threads, int* smem_bytes) {
  const int rc = fused_prepare<NK>();
  if (rc != 0) return rc;
  const int tp = (T + 15) & ~15;
  *threads = 32 * fused_warps(NK);
  *smem_bytes = fused_smem_bytes(tp, NK * 16);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, flash_bwd_fused_kernel<NK>, *threads, *smem_bytes));
}

}  // namespace

// strides: element strides (b, h, t|s) of q, k, v, do, dq, in that order; the
// last dimension of each is contiguous. m, l are contiguous fp32 [B*H, T];
// delta [B*H, T] is written here, for flash_bwd_dkv_bf16 to read. Built for
// D = 64 (GPT-2's head width); another width is instantiated with the model
// that needs it. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// another D.
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const int* key_mask, const void* dout, const float* m,
                                 const float* l, float* delta, void* dq, int B, int H,
                                 int Hkv, int T, int S, int D, const long long* st,
                                 int causal, int q_offset, float sm_scale, void* stream) {
  if (D != 64) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B * H, (T + BQ - 1) / BQ);
  flash_bwd_dq_kernel<64><<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      key_mask, static_cast<const bf16*>(dout), m, l, delta, static_cast<bf16*>(dq), H, Hkv, T, S,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      st[12], st[13], st[14], causal, q_offset, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// strides: element strides (b, h, t|s) of q, k, v, do, dk, dv, in that order;
// delta is the one flash_bwd_dq_bf16 wrote. Any GQA group size H / Hkv: the
// kernel loops over the group's heads.
extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                  const int* key_mask, const void* dout, const float* m,
                                  const float* l, const float* delta, void* dk, void* dv, int B,
                                  int H, int Hkv, int T, int S, int D, const long long* st,
                                  int causal, int q_offset, float sm_scale, void* stream) {
  if (D != 64) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B * Hkv, (S + BK - 1) / BK);
  flash_bwd_dkv_kernel<64><<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      key_mask, static_cast<const bf16*>(dout), m, l, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, Hkv, T, S, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14], st[15], st[16], st[17],
      causal, q_offset, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// The fused route, T, S <= 128 and D = 64. strides: element strides
// (b, h, t|s) of q, k, v, do, dq, dk, dv, in that order; the last dimension of
// each is contiguous. m, l are contiguous fp32 [B*H, T]. dkv_part is fp32
// scratch of B*Hkv*ceil16(S)*128 floats (each CTA's running dk/dv sum over
// its GQA group), needed only when H > Hkv (null otherwise).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// another D, a longer T or S, or a missing scratch.
extern "C" int flash_bwd_fused_bf16(const void* q, const void* k, const void* v, const int* key_mask,
                                    const void* dout, const float* m, const float* l, void* dq, void* dk,
                                    void* dv, float* dkv_part, int B, int H, int Hkv, int T, int S, int D,
                                    const long long* st, int causal, int q_offset, float sm_scale,
                                    void* stream) {
  if (D != 64 || T < 1 || S < 1 || T > FUSED_MAX || S > FUSED_MAX || Hkv < 1 || H % Hkv ||
      (H > Hkv && dkv_part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((S + 15) / 16) {
#define FUSED_CASE(NK)                                                                                     \
  case NK:                                                                                                 \
    return fused_launch<NK>(q, k, v, key_mask, dout, m, l, dq, dk, dv, dkv_part, B, H, Hkv, T, S, st, causal, \
                            q_offset, sm_scale, s);
    FUSED_CASE(1) FUSED_CASE(2) FUSED_CASE(3) FUSED_CASE(4)
    FUSED_CASE(5) FUSED_CASE(6) FUSED_CASE(7) FUSED_CASE(8)
#undef FUSED_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// What a fused launch at (T, S) gets: its threads, its dynamic shared memory
// and the CTAs an SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int flash_bwd_fused_occupancy(int T, int S, int* ctas_per_sm, int* threads, int* smem_bytes) {
  if (T < 1 || S < 1 || T > FUSED_MAX || S > FUSED_MAX) return static_cast<int>(cudaErrorInvalidValue);
  switch ((S + 15) / 16) {
#define FUSED_CASE(NK) \
  case NK:             \
    return fused_occupancy<NK>(T, ctas_per_sm, threads, smem_bytes);
    FUSED_CASE(1) FUSED_CASE(2) FUSED_CASE(3) FUSED_CASE(4)
    FUSED_CASE(5) FUSED_CASE(6) FUSED_CASE(7) FUSED_CASE(8)
#undef FUSED_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
