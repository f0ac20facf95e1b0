// Bias-carrying flash-attention backward for Hopper (sm_90a), bf16 in, fp32
// accumulation, in two routes chosen by the wrapper from the shape:
// - the fused route, T, S <= 128: flash_bias_bwd_fused_kernel, ONE launch that
//   gives dq, dk, dv and dbias;
// - the long route, past 128: flash_bias_bwd_dq_kernel with
//   flash_bias_dbias_reduce_kernel, then flash_bias_bwd_dkv_kernel.
//
// Replaces: trlx_tpu/ops/flash_attention.py : _flash_bias_backward, i.e. its
// two pallas_calls (:665 and :703), _dq_dbias_kernel (:550) and
// _dkv_bias_kernel (:594). Both routes compute its function.
//
// Given the forward's inputs q [B,H,T,D], k/v [B,H,S,D] (no GQA), key_mask
// [B,S], the fp32 bias [H,T,S], the softmax stats m, l [B*H,T] (fp32) and the
// output gradient do [B,H,T,D]:
//   s[t,j]  = (q[t] . k[j]) * sm_scale + bias[h,t,j], replaced by -1e30 where
//             (t, j) is masked (key_mask == 0, or causal and t < j: top-left,
//             no query offset),
//   p[t,j]  = exp(s - m[t]) / max(l[t], 1e-30),
//   dp[t,j] = do[t] . v[j],
//   delta[t] = sum over the row's valid pairs of p dp (fp32),
//   ds[t,j] = valid ? p (dp - delta[t]) : 0          (the gradient of s + bias),
//   dq[t]   = sm_scale sum_j ds[t,j] k[j],   dk[j] = sm_scale sum_t ds[t,j] q[t],
//   dv[j]   = sum_t p[t,j] do[t],            dbias[h,t,j] = sum_b ds[b,h,t,j].
// A fully masked row (m = -1e30) has p = 1/l at every slot, so it adds do/l
// to dv at every slot; its ds is zero. Slots past S and rows past T take and
// give no weight.
//
// What bounds it on this card: per (b, h) five products of 2*D flops for each
// weighed (t, j) pair over 2 bytes per element of q, k, v, do, dq, dk, dv,
// plus the fp32 bias read and the dbias write (4*T*S bytes a head, shared by
// the batch). At T5's shapes (T, S of 32 to 128, D = 64) that is far below
// the H100's ~295 flop/byte ridge: the function is bound by its bytes, and at
// these sizes in practice by latency: launches, the dependency between them,
// and the walks over K/V.
//
// Precision (both routes), as in csrc/flash_bwd.cu: delta = sum_j p dp is
// summed from the same p and dp that form ds (the TPU's rowsum(do * out)
// uses the bf16 out, whose rounding shifts every ds of the row alike), each
// product takes ds as two bf16 parts, hi = bf16(ds) and lo = bf16(ds - hi),
// and dbias comes from the fp32 ds, never from the bf16 halves: it feeds a
// [buckets, H] table through a gather over B*T*S entries.
//
// dbias is a sum over the batch. The TPU kernel carries it across its
// batch-innermost grid axis; Hopper's CTAs run in no order, and float atomics
// would make the sum change from run to run. Both routes write each (b, h)'s
// fp32 ds into a per-batch partial [B, H, T, S] and sum the partials over b
// in order 0..B-1, so dbias has the same bits run to run.
//
// The fused route (flash_bias_bwd_fused_kernel), one CTA per (b, h) holding
// the whole [T, S] tile:
// 1. Q, dO, K and V enter shared memory once, by cp.async with zero fill
//    (only attendable K/V rows are read), while the first strip's bias is
//    loaded into its score accumulators. The dynamic shared memory is sized
//    from ceil16(T) and ceil16(S), not from 128, and the registers are
//    bounded per instantiation, so that the B*H = 144 CTAs of a T5 layer run
//    in one wave (three CTAs an SM at S = 32, two at S = 65, one at 128).
// 2. Each product once. The query-major phase has one warp per 16-row strip:
//    it computes s and dp over the strip's whole row (registers: the kernel
//    is instantiated per ceil16(S) / 16, so a strip holds 2 * S/8 fp32
//    fragments of each and no more), sums delta from them in fp32, forms ds,
//    writes the batch's fp32 ds partial, takes dq = ds K, and leaves p (bf16)
//    and ds (bf16 hi and lo) in shared memory. The key-major phase, one warp
//    per 16-slot strip, takes dv = p^T dO and dk = ds^T Q from there. Every
//    fragment comes by ldmatrix (.trans for the transposed operands). No s
//    or dp is recomputed, the bias is read once, and delta never leaves the
//    CTA.
// 3. dbias with no second launch and no float atomics: the partial is
//    written in mma-fragment order, a float4 per lane and 8-slot tile (tiles
//    wholly in the causal future are skipped); each CTA then fences and one
//    thread increments head h's int32 arrival counter; the CTA that arrives
//    last for h sums the B partials of h in order, float4 loads through L2
//    (__ldcg) with four batch rows in flight, writes dbias[h] (zero in the
//    causal future) and resets the counter to 0. The wrapper zeroes the
//    counters once; the kernel leaves them zeroed.
// Every global load that feeds a product is unconditional, at a clamped
// address where its value is not used: a load under a branch does not
// overlap the next one.
// What still holds it back at T5's shapes (H100, cumulative device time of
// the kernel cut after each stage; PERF.md): the launch itself (~5 us of
// 16-28), the query-major phase and the last CTA's dbias sum.

// The long route, past 128 (the reference also shapes its tiles by S):
// - flash_bias_bwd_dq_kernel, one CTA per (b*h, 64-row query tile) as the
//   plain dq kernel (csrc/flash_bwd.cu), walks K/V twice (delta, then ds)
//   and writes each pair's fp32 ds into the per-batch partial beside dq.
//   Pairs wholly in the causal future are skipped and not written;
// - flash_bias_dbias_reduce_kernel sums the partials over b in order, one
//   thread per (h, t, j), and writes zero for causal-future pairs;
// - flash_bias_bwd_dkv_kernel, one CTA per (b*h, 64-slot key tile), holds its
//   k and v rows in registers and loops over the query tiles on the
//   transposed tile (keys x queries), reading the delta the dq kernel wrote
//   and the bias transposed from device memory (eight neighbouring slots of
//   one bias row per fragment column: a 32-byte sector).
// Its tiles are fixed at 64 rows whatever T and S, so any length runs; the
// cost is three launches and s, dp computed three times.
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
flash_bias_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const int* __restrict__ key_mask,
                         const float* __restrict__ bias,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ m_in, const float* __restrict__ l_in,
                         float* __restrict__ delta_out,
                         __nv_bfloat16* __restrict__ dq,
                         float* __restrict__ ds_part,
                         int H, int T, int S,
                         long long q_sb, long long q_sh, long long q_st,
                         long long k_sb, long long k_sh, long long k_ss,
                         long long v_sb, long long v_sh, long long v_ss,
                         long long do_sb, long long do_sh, long long do_st,
                         long long dq_sb, long long dq_sh, long long dq_st,
                         int causal, float sm_scale) {
  constexpr int KSTEPS = D / 16;
  constexpr int NT_D = D / 8;
  constexpr int LDS = D + 8;  // padded shared row, in bf16 elements

  __shared__ __align__(16) __nv_bfloat16 k_s[BK * LDS];
  __shared__ __align__(16) __nv_bfloat16 v_s[BK * LDS];
  __shared__ int valid_s[BK];  // 1 attendable slot, 0 masked or past the end

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8

  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  const int* mb = key_mask + (long long)b * S;
  const float* biasb = bias + (long long)h * T * S;
  float* dsb = ds_part + (long long)bh * T * S;

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
  // ds with it, writes it to the batch's dbias partial and accumulates dq
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
    // add nothing there (the reduce kernel writes those dbias entries zero)
    if (causal && kv0 > row_last) break;
    __syncthreads();  // the previous tile is consumed
    constexpr int VECS = D / 8;  // 16-byte vectors per row
    for (int i = threadIdx.x; i < BK * VECS; i += NTHREADS) {
      const int row = i / VECS, col = (i % VECS) * 8;
      const int slot = kv0 + row;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      // only attendable slots inside some row's causal window carry ds != 0
      if (slot < S && mb[slot] > 0 && !(causal && slot > row_last)) {
        kx = *reinterpret_cast<const uint4*>(kb + slot * k_ss + col);
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
          const int flag = valid_s[col];
          const bool ok = flag > 0 && row < T && !(causal && row < kv0 + col);
          const float p = ok
              ? __expf(s[nn][e] * sm_scale + biasb[(long long)row * S + kv0 + col] - m_r[i]) * linv[i]
              : 0.f;
          if (pass == 0) {
            dlt[i] += p * dp[nn][e];
          } else {
            const float ds = ok ? p * (dp[nn][e] - dlt[i]) : 0.f;  // d(score + bias)
            if (flag >= 0 && row < T) dsb[(long long)row * S + kv0 + col] = ds;
            s[nn][e] = ds * sm_scale;  // the dq product's operand
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

// dbias[h, t, j] = sum over b, in order, of the dq kernel's partials; zero
// for a causal-future pair, which the dq kernel may not have written
__global__ void flash_bias_dbias_reduce_kernel(const float* __restrict__ ds_part,
                                               float* __restrict__ dbias, int B, int H, int T,
                                               int S, int causal) {
  const long long n = (long long)H * T * S;  // = the stride of one batch row
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * blockDim.x) {
    const int j = static_cast<int>(idx % S);
    const int t = static_cast<int>((idx / S) % T);
    float sum = 0.f;
    if (!(causal && t < j)) {
      for (int b = 0; b < B; ++b) sum += ds_part[b * n + idx];
    }
    dbias[idx] = sum;
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_bias_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const int* __restrict__ key_mask,
                          const float* __restrict__ bias,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ m_in, const float* __restrict__ l_in,
                          const float* __restrict__ delta_in,
                          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                          int H, int T, int S,
                          long long q_sb, long long q_sh, long long q_st,
                          long long k_sb, long long k_sh, long long k_ss,
                          long long v_sb, long long v_sh, long long v_ss,
                          long long do_sb, long long do_sh, long long do_st,
                          long long dk_sb, long long dk_sh, long long dk_ss,
                          long long dv_sb, long long dv_sh, long long dv_ss,
                          int causal, float sm_scale) {
  constexpr int KSTEPS = D / 16;
  constexpr int NT_D = D / 8;
  constexpr int LDS = D + 8;

  __shared__ __align__(16) __nv_bfloat16 q_s[BQ * LDS];
  __shared__ __align__(16) __nv_bfloat16 do_s[BQ * LDS];
  __shared__ float m_s[BQ], linv_s[BQ], dlt_s[BQ];
  __shared__ int row_s[BQ];  // 1 a row of T, 0 past its end

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kv0 = blockIdx.y * BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int j0 = kv0 + warp * 16 + g;  // this thread's key slots: j0 and j0 + 8
  const int* mb = key_mask + (long long)b * S;
  const float* biasb = bias + (long long)h * T * S;

  // a masked key's s is -1e30 and its ds zero whatever its K and V: only
  // attendable keys are read
  bool kvalid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int slot = j0 + i * 8;
    kvalid[i] = slot < S && mb[slot] > 0;
  }
  uint32_t kf[KSTEPS][4], vf[KSTEPS][4];
  load_a_rows<D>(kf, k + b * k_sb + h * k_sh, k_ss, j0, kvalid[0], kvalid[1], c);
  load_a_rows<D>(vf, v + b * v_sb + h * v_sh, v_ss, j0, kvalid[0], kvalid[1], c);

  float dk_acc[NT_D][4], dv_acc[NT_D][4];
#pragma unroll
  for (int n = 0; n < NT_D; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* dob = dout + b * do_sb + h * do_sh;
  const int n_qt = (T + BQ - 1) / BQ;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int t0 = qt * BQ;
    const int t_last = min(t0 + BQ, T) - 1;
    __syncthreads();  // the previous tile is consumed
    if (threadIdx.x < BQ) {
      const int t = t0 + threadIdx.x;
      const bool ok = t < T;
      m_s[threadIdx.x] = ok ? m_in[(long long)bh * T + t] : 0.f;
      linv_s[threadIdx.x] = ok ? 1.f / fmaxf(l_in[(long long)bh * T + t], 1e-30f) : 0.f;
      dlt_s[threadIdx.x] = ok ? delta_in[(long long)bh * T + t] : 0.f;
      row_s[threadIdx.x] = ok ? 1 : 0;
    }
    __syncthreads();
    if (causal && t_last < kv0) {
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
          const int t = t0 + col;
          float p = 0.f, ds = 0.f;
          if (row_s[col] && slot < S) {
            const bool ok = kvalid[i] && !(causal && t < slot);
            const float x = ok ? st[nn][e] * sm_scale + biasb[(long long)t * S + slot] : NEG_INF;
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

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int slot = j0 + i * 8;
    if (slot >= S) continue;
    __nv_bfloat16* krow = dk + b * dk_sb + h * dk_sh + slot * dk_ss;
    __nv_bfloat16* vrow = dv + b * dv_sb + h * dv_sh + slot * dv_ss;
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

constexpr int FUSED_MAX = 128;   // the longest T or S the fused kernel takes
constexpr int FUSED_LDS = 64 + 8;  // padded Q / dO / K / V row, bf16 elements (D = 64)
constexpr int FUSED_RED = 4;     // float4 dbias slots a thread of the last CTA sums at once

// warps of the fused kernel: one per 16-slot key strip, at least four
__host__ __device__ constexpr int fused_warps(int nk) { return nk > 4 ? nk : 4; }

// dynamic shared memory of the fused kernel for tp = ceil16(T), sp = ceil16(S):
// q, do [tp][72], k, v [sp][72], p, ds hi, ds lo [tp][sp + 8] (bf16), and
// the slots' flags [sp] (int); every region starts on a 16-byte boundary
inline int fused_smem_bytes(int tp, int sp) {
  return 2 * (2 * tp + 2 * sp) * FUSED_LDS + 2 * 3 * tp * (sp + 8) + 4 * sp;
}

// The scores of one 16-row strip start from bias / sm_scale on its valid
// pairs (zero elsewhere), so that s * sm_scale after the QK^T product is the
// score with its bias. The loads are unconditional, at a clamped address
// where the value is not needed: a load under a branch cannot overlap the
// next one, and each would cost a whole memory latency.
template <int NT_S>
__device__ __forceinline__ void bias_into_scores(float (&s)[NT_S][4], const float* biasb, const int* valid_s,
                                                 int r0, int T, int S, int causal, float inv_scale, int c) {
#pragma unroll
  for (int n = 0; n < NT_S; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + (e >> 1) * 8, col = n * 8 + c * 2 + (e & 1);
      const bool ok = valid_s[col] > 0 && row < T && !(causal && row < col);
      const float x = __ldg(biasb + (long long)min(row, T - 1) * S + min(col, S - 1));
      s[n][e] = ok ? x * inv_scale : 0.f;
    }
  }
}

// One CTA per (b, h) of fused_warps(NK) warps; NK = ceil16(S) / 16 sizes the
// strips' registers. Registers are bounded so that B*H CTAs of T5's shapes
// run in one wave: up to NK = 4, two CTAs an SM at any count; at NK = 5 (T5's
// decoder) 168, so that two CTAs of 5 warps share an SM (each of its four
// register banks of 16K holds three such warps).
template <int NK>
__global__ void __launch_bounds__(NK == 5 ? 192 : (NK > 4 ? 32 * NK : 128), NK <= 5 ? 2 : 1)
flash_bias_bwd_fused_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const int* __restrict__ key_mask,
                            const float* __restrict__ bias, const bf16* __restrict__ dout,
                            const float* __restrict__ m_in, const float* __restrict__ l_in,
                            bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                            float* ds_part, float* __restrict__ dbias, int* arrivals,
                            int B, int H, int T, int S,
                            long long q_sb, long long q_sh, long long q_st,
                            long long k_sb, long long k_sh, long long k_ss,
                            long long v_sb, long long v_sh, long long v_ss,
                            long long do_sb, long long do_sh, long long do_st,
                            long long dq_sb, long long dq_sh, long long dq_st,
                            long long dk_sb, long long dk_sh, long long dk_ss,
                            long long dv_sb, long long dv_sh, long long dv_ss,
                            int causal, float sm_scale) {
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
  __shared__ int last_s;
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

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int* mb = key_mask + (long long)b * S;
  const float* biasb = bias + (long long)h * T * S;
  const float inv_scale = 1.f / sm_scale;
  // the per-batch ds partial of this (b, h), TP x SP fp32 in fragment order:
  // strip st, 8-slot tile n, lane -> one float4 (rows g, g + 8; slots 2c, 2c + 1)
  float4* part = reinterpret_cast<float4*>(ds_part) + (long long)bh * (TP * SP / 4);

  // 1. the operands into shared memory, once, by cp.async (zero-filled past
  // T and S and on masked slots: their s is -1e30 and their ds zero whatever
  // K and V hold); the key flags and the first strip's bias meanwhile
  {
    const bf16* qb = q + b * q_sb + h * q_sh;
    const bf16* dob = dout + b * do_sb + h * do_sh;
    constexpr int VECS = D / 8;  // 16-byte vectors per row
    for (int i = tid; i < TP * VECS; i += NTHREADS) {
      const int row = i / VECS, col = (i % VECS) * 8;
      const bool ok = row < T;
      cp_async16(&q_s[row * LDS + col], qb + (ok ? row * q_st + col : 0), ok);
      cp_async16(&do_s[row * LDS + col], dob + (ok ? row * do_st + col : 0), ok);
    }
    for (int i = tid; i < SP; i += NTHREADS) valid_s[i] = i < S ? (mb[i] > 0 ? 1 : 0) : -1;
  }
  __syncthreads();  // valid_s
  {
    const bf16* kb = k + b * k_sb + h * k_sh;
    const bf16* vb = v + b * v_sb + h * v_sh;
    constexpr int VECS = D / 8;
    for (int i = tid; i < SP * VECS; i += NTHREADS) {
      const int row = i / VECS, col = (i % VECS) * 8;
      const bool ok = valid_s[row] > 0;
      cp_async16(&k_s[row * LDS + col], kb + (ok ? row * k_ss + col : 0), ok);
      cp_async16(&v_s[row * LDS + col], vb + (ok ? row * v_ss + col : 0), ok);
    }
  }
  float s[NT_S][4];
  bias_into_scores<NT_S>(s, biasb, valid_s, warp * 16 + g, T, S, causal, inv_scale, c);
  cp_async_wait_all();
  __syncthreads();

  // 2a. query-major: a warp per 16-row strip over the whole row of S slots
  // (one strip a warp unless T > S)
  for (int st = warp; st < n_strips; st += NWARPS) {
    const int r0 = st * 16 + g;  // this thread's rows: r0 and r0 + 8
    float m_r[2], linv[2], dlt[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + i * 8;
      const long long at = (long long)bh * T + min(row, T - 1);
      const float mv = __ldg(m_in + at), lv = __ldg(l_in + at);
      m_r[i] = row < T ? mv : 0.f;
      linv[i] = row < T ? 1.f / fmaxf(lv, 1e-30f) : 0.f;
    }
    float dp[NT_S][4];
#pragma unroll
    for (int n = 0; n < NT_S; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t qa[4], da[4];
      ldm_a<LDS>(qa, q_s, st * 16, ks, lane);
      ldm_a<LDS>(da, do_s, st * 16, ks, lane);
#pragma unroll
      for (int n = 0; n < NT_S; n += 2) {
        uint32_t kf[4], vf[4];
        ldm_b_cols<LDS>(kf, k_s, ks, n, lane);
        ldm_b_cols<LDS>(vf, v_s, ks, n, lane);
        mma_bf16(s[n], qa, kf[0], kf[1]);
        mma_bf16(s[n + 1], qa, kf[2], kf[3]);
        mma_bf16(dp[n], da, vf[0], vf[1]);
        mma_bf16(dp[n + 1], da, vf[2], vf[3]);
      }
    }

    // p on the valid pairs (zero elsewhere) replaces s, and delta sums p dp;
    // p_s takes the weights dv needs, which for a row that attends no slot
    // are 1/l at every slot of S
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
          const bool ok = flag > 0 && row < T && !(causal && row < col);
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
    // ds = p (dp - delta), zero where p is: the fp32 ds into the batch's
    // dbias partial (tiles wholly in the causal future are neither written
    // nor read), ds * sm_scale (the dq and dk products' operand) into s and,
    // as bf16 hi and lo, into shared memory for the key-major phase
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = s[n][e] * (dp[n][e] - dlt[e >> 1]);
      if (!(causal && st * 16 + 15 < n * 8))
        part[(st * NT_S + n) * 32 + lane] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float x0 = s[n][2 * i] * sm_scale, x1 = s[n][2 * i + 1] * sm_scale;
        s[n][2 * i] = x0;
        s[n][2 * i + 1] = x1;
        const int at = (r0 + i * 8) * LDP + n * 8 + c * 2;
        *reinterpret_cast<uint32_t*>(&dhi_s[at]) = pack_f32(x0, x1);
        *reinterpret_cast<uint32_t*>(&dlo_s[at]) = pack_f32(bf16_rest(x0), bf16_rest(x1));
      }
    }
    // dq = (ds * sm_scale) K over the strip's row
    float acc[NT_D][4];
#pragma unroll
    for (int n = 0; n < NT_D; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
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
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + i * 8;
      if (row >= T) continue;
      bf16* orow = dq + b * dq_sb + h * dq_sh + row * dq_st;
#pragma unroll
      for (int n = 0; n < NT_D; ++n)
        *reinterpret_cast<uint32_t*>(orow + n * 8 + c * 2) = pack_f32(acc[n][2 * i], acc[n][2 * i + 1]);
    }
    if (st + NWARPS < n_strips)
      bias_into_scores<NT_S>(s, biasb, valid_s, r0 + NWARPS * 16, T, S, causal, inv_scale, c);
  }
  __syncthreads();  // p and ds are in shared memory

  // 2b. key-major: a warp per 16-slot strip; dv = p^T dO, dk = ds^T Q
  if (warp < NK) {
    const int j0 = warp * 16;
    float dk_acc[NT_D][4], dv_acc[NT_D][4];
#pragma unroll
    for (int n = 0; n < NT_D; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
    for (int kt = 0; kt < n_strips; ++kt) {
      uint32_t pa[4], dh[4], dl[4];
      ldm_a_trans<LDP>(pa, p_s, j0, kt, lane);
      ldm_a_trans<LDP>(dh, dhi_s, j0, kt, lane);
      ldm_a_trans<LDP>(dl, dlo_s, j0, kt, lane);
#pragma unroll
      for (int n = 0; n < NT_D; n += 2) {
        uint32_t of[4], qf[4];
        ldm_b_rows<LDS>(of, do_s, kt, n, lane);
        ldm_b_rows<LDS>(qf, q_s, kt, n, lane);
        mma_bf16(dv_acc[n], pa, of[0], of[1]);
        mma_bf16(dv_acc[n + 1], pa, of[2], of[3]);
        mma_bf16(dk_acc[n], dh, qf[0], qf[1]);
        mma_bf16(dk_acc[n], dl, qf[0], qf[1]);
        mma_bf16(dk_acc[n + 1], dh, qf[2], qf[3]);
        mma_bf16(dk_acc[n + 1], dl, qf[2], qf[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int slot = j0 + g + i * 8;
      if (slot >= S) continue;
      bf16* krow = dk + b * dk_sb + h * dk_sh + slot * dk_ss;
      bf16* vrow = dv + b * dv_sb + h * dv_sh + slot * dv_ss;
#pragma unroll
      for (int n = 0; n < NT_D; ++n) {
        *reinterpret_cast<uint32_t*>(krow + n * 8 + c * 2) = pack_f32(dk_acc[n][2 * i], dk_acc[n][2 * i + 1]);
        *reinterpret_cast<uint32_t*>(vrow + n * 8 + c * 2) = pack_f32(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
      }
    }
  }

  // 3. dbias: the last of head h's B CTAs to arrive sums their partials in
  // order b = 0..B-1 (through L2: other SMs wrote them) and resets the counter
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(arrivals + h, 1) == B - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // FUSED_RED float4 slots a thread at once, the loads of four batch rows in
  // flight; the loads are unconditional (a tile wholly in the causal future
  // reads slot 0 and adds nothing)
  const int n_vec = TP * SP / 4;
  const float4* head = reinterpret_cast<const float4*>(ds_part) + (long long)h * n_vec;
  const long long b_stride = (long long)H * n_vec;
  float* dbias_h = dbias + (long long)h * T * S;
  for (int f0 = tid; f0 < n_vec; f0 += FUSED_RED * NTHREADS) {
    float4 acc[FUSED_RED];
    bool need[FUSED_RED];
    int at[FUSED_RED];
#pragma unroll
    for (int e = 0; e < FUSED_RED; ++e) {
      const int f = f0 + e * NTHREADS;
      const int st = f / (NT_S * 32), n = (f / 32) % NT_S;
      need[e] = f < n_vec && !(causal && st * 16 + 15 < n * 8);
      at[e] = need[e] ? f : 0;
      acc[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll 4
    for (int bb = 0; bb < B; ++bb) {
      const float4* src = head + bb * b_stride;
#pragma unroll
      for (int e = 0; e < FUSED_RED; ++e) {
        const float4 x = __ldcg(src + at[e]);
        // acc is never -0, so adding +0 keeps its bits
        acc[e].x += need[e] ? x.x : 0.f;
        acc[e].y += need[e] ? x.y : 0.f;
        acc[e].z += need[e] ? x.z : 0.f;
        acc[e].w += need[e] ? x.w : 0.f;
      }
    }
#pragma unroll
    for (int e = 0; e < FUSED_RED; ++e) {
      const int f = f0 + e * NTHREADS;
      if (f >= n_vec) continue;
      const int st = f / (NT_S * 32), n = (f / 32) % NT_S, ln = f % 32;
      const int t0 = st * 16 + (ln >> 2), j0 = n * 8 + (ln & 3) * 2;
      const float vals[4] = {acc[e].x, acc[e].y, acc[e].z, acc[e].w};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int t = t0 + (x >> 1) * 8, j = j0 + (x & 1);
        if (t < T && j < S) dbias_h[t * S + j] = vals[x];  // zero in the causal future
      }
    }
  }
  if (tid == 0) arrivals[h] = 0;
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
  err = cudaFuncSetAttribute(flash_bias_bwd_fused_kernel<NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             fused_smem_bytes(FUSED_MAX, NK * 16));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64) done |= 1ULL << dev;
  return 0;
}

template <int NK>
int fused_launch(const void* q, const void* k, const void* v, const int* key_mask, const float* bias,
                 const void* dout, const float* m, const float* l, void* dq, void* dk, void* dv,
                 float* ds_part, float* dbias, int* arrivals, int B, int H, int T, int S,
                 const long long* st, int causal, float sm_scale, cudaStream_t stream) {
  const int rc = fused_prepare<NK>();
  if (rc != 0) return rc;
  const int tp = (T + 15) & ~15;
  flash_bias_bwd_fused_kernel<NK><<<B * H, 32 * fused_warps(NK), fused_smem_bytes(tp, NK * 16), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), key_mask, bias,
      static_cast<const bf16*>(dout), m, l, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), ds_part, dbias, arrivals, B, H, T, S, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14], st[15], st[16], st[17], st[18],
      st[19], st[20], causal, sm_scale);
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
      ctas_per_sm, flash_bias_bwd_fused_kernel<NK>, *threads, *smem_bytes));
}

}  // namespace

// The long route (any T and S), first launch pair. strides: element strides
// (b, h, t|s) of q, k, v, do, dq, in that order; the last dimension of each is
// contiguous. bias is a contiguous fp32 [H, T, S];
// m, l are contiguous fp32 [B*H, T]; delta [B*H, T] is written here, for
// flash_bias_bwd_dkv_bf16 to read; ds_part is fp32 scratch [B, H, T, S] and
// dbias a contiguous fp32 [H, T, S], both written here (the dq kernel, then
// the reduce kernel, on the same stream). Built for D = 64 (T5's d_kv).
// Returns cudaGetLastError() after the second launch (or the first launch's
// error), or cudaErrorInvalidValue for another D.
extern "C" int flash_bias_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                      const int* key_mask, const float* bias, const void* dout,
                                      const float* m, const float* l, float* delta, void* dq,
                                      float* ds_part, float* dbias, int B, int H, int T, int S,
                                      int D, const long long* st, int causal, float sm_scale,
                                      void* stream) {
  if (D != 64) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * H, (T + BQ - 1) / BQ);
  flash_bias_bwd_dq_kernel<64><<<grid, NTHREADS, 0, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      key_mask, bias, static_cast<const bf16*>(dout), m, l, delta, static_cast<bf16*>(dq),
      ds_part, H, T, S, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], st[12], st[13], st[14], causal, sm_scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = (long long)H * T * S;
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 132LL * 16 ? want : 132LL * 16);
  flash_bias_dbias_reduce_kernel<<<blocks, threads, 0, s>>>(ds_part, dbias, B, H, T, S, causal);
  return static_cast<int>(cudaGetLastError());
}

// The long route, second launch. strides: element strides (b, h, t|s) of q, k,
// v, do, dk, dv, in that order; delta is the one flash_bias_bwd_dq_bf16 wrote.
extern "C" int flash_bias_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                       const int* key_mask, const float* bias, const void* dout,
                                       const float* m, const float* l, const float* delta,
                                       void* dk, void* dv, int B, int H, int T, int S, int D,
                                       const long long* st, int causal, float sm_scale,
                                       void* stream) {
  if (D != 64) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B * H, (S + BK - 1) / BK);
  flash_bias_bwd_dkv_kernel<64><<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      key_mask, bias, static_cast<const bf16*>(dout), m, l, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, T, S, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], st[12], st[13], st[14], st[15], st[16], st[17], causal,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// The fused route, T, S <= 128 and D = 64. strides: element strides
// (b, h, t|s) of q, k, v, do, dq, dk, dv, in that order; the last dimension of
// each is contiguous. bias is a contiguous fp32 [H, T, S]; m, l are contiguous
// fp32 [B*H, T]; dbias a contiguous fp32 [H, T, S]; ds_part fp32 scratch of
// B*H*ceil16(T)*ceil16(S) floats (each (b, h)'s partial in mma-fragment
// order), 16-byte aligned; arrivals an int32 [>= H] that is zero before the
// launch and is left zero after it (so launches sharing it must be ordered:
// one stream).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// another D or a longer T or S.
extern "C" int flash_bias_bwd_fused_bf16(const void* q, const void* k, const void* v,
                                         const int* key_mask, const float* bias, const void* dout,
                                         const float* m, const float* l, void* dq, void* dk, void* dv,
                                         float* ds_part, float* dbias, int* arrivals, int B, int H,
                                         int T, int S, int D, const long long* st, int causal,
                                         float sm_scale, void* stream) {
  if (D != 64 || T < 1 || S < 1 || T > FUSED_MAX || S > FUSED_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((S + 15) / 16) {
#define FUSED_CASE(NK)                                                                                 \
  case NK:                                                                                             \
    return fused_launch<NK>(q, k, v, key_mask, bias, dout, m, l, dq, dk, dv, ds_part, dbias, arrivals, \
                            B, H, T, S, st, causal, sm_scale, s);
    FUSED_CASE(1) FUSED_CASE(2) FUSED_CASE(3) FUSED_CASE(4)
    FUSED_CASE(5) FUSED_CASE(6) FUSED_CASE(7) FUSED_CASE(8)
#undef FUSED_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// What a fused launch at (T, S) gets: its threads, its dynamic shared memory
// and the CTAs an SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int flash_bias_bwd_fused_occupancy(int T, int S, int* ctas_per_sm, int* threads,
                                              int* smem_bytes) {
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

extern "C" const char* flash_bias_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
