// Flash-attention backward for Hopper (sm_90a): the dq kernel and the dk/dv
// kernel, bf16 in, fp32 accumulation.
//
// Replaces: trlx_tpu/ops/flash_attention.py : _flash_backward, i.e. its two
// pallas_calls, _dq_kernel (:192) and _dkv_kernel (:231).
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
// What bounds it on this card: per (b, h) the three products of the dq kernel
// and the four of the dk/dv kernel do 2*D flops for each weighed (t, j) pair,
// over 2 bytes per element of q, k, v, do, dq, dk, dv: at the training shapes
// (T = S = 64..72, D = 64, causal, left-padded) that is some 14-17 flops a
// byte (chip_smoke.py's flash_bwd_work), far below the
// H100's ~295 flop/byte ridge, so the function is bound by its bytes, and at
// these small sizes in practice by latency (one or two waves of CTAs).
// The design reads each operand once per CTA from device memory and never
// lets a [T, S] tile reach it: p is rebuilt in registers from (q, k, m, l).
// Two kernels and no atomics, as in the TPU design, so the result is the
// same run to run:
// - dq: one CTA per (b*h, 64-row query tile), its q and do rows held in
//   registers as mma fragments; K/V stream through shared memory in 64-slot
//   tiles. S = Q K^T and dP = dO V^T run on mma.sync m16n8k16 (bf16 in, fp32
//   accumulate), 16 slots at a time. A first pass over the tiles sums
//   delta = sum_j p dp in fp32 and writes it out for the dk/dv kernel; the
//   second forms dS in registers and multiplies it into dQ += dS K. Tiles
//   wholly in every row's causal future are skipped (they carry ds = 0), and
//   K/V rows of masked or causal-future slots are never read.
//   Why the care with ds: a row's ds sum to zero, so dq = sum_j ds k_j does
//   not see the part of the keys common to all slots, and dk and the key
//   projection's gradient likewise cancel along the queries' common part.
//   In GPT-2 that common part is large against what varies, so an error that
//   moves a row's ds sum off zero is multiplied by it. Two such errors:
//   - delta = rowsum(do * out), as the TPU kernel forms it, uses the bf16
//     out, whose rounding shifts every ds of the row alike; delta summed
//     from the same p and dp that form ds keeps the row sum at zero;
//   - ds rounded to bf16 for the tensor cores: each product takes ds as two
//     bf16 parts, hi = bf16(ds) and lo = bf16(ds - hi), so it carries 16
//     bits, as close to fp32 as the plain path's fp32 ds.
//   The first version of these kernels had both, and the q/k projection
//   gradients of GPT-2 small came out up to 8x further from fp32 than the
//   plain bf16 path's (chip_smoke.py train_reference on an H100); the
//   plain backward run on the kernel's bf16 out strays about as far there.
// - dk/dv: one CTA per (b*hkv, 64-slot key tile), its k and v rows held in
//   registers; it loops over the query tiles of ALL heads of the GQA group,
//   so the group sum happens in registers (the TPU kernel's rep*T rows).
//   It works on the transposed tile (keys x queries): S^T = K Q^T,
//   dP^T = V dO^T, dV += P^T dO (P in bf16, as the plain path's probs),
//   dK += dS^T Q (dS as hi + lo). A query tile wholly before
//   the key tile is skipped only when no row of it is fully masked
//   (__syncthreads_or over the tile's m), as the forward's tile skip.
// Registers: up to 255 a thread (two CTAs an SM), so the fragments and both
// fp32 accumulators stay out of local memory. TMA, wgmma and pipelining are
// later work.

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

extern "C" const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
