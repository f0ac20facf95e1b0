// Kernel 10: the W8A16 product of QDense's int8 decode weights, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: trlx_tpu/models/transformer.py's QDense runs
// its int8 branch (`quantize_decode_weights`) as an XLA dot whose int8 ->
// bf16 convert fuses into the operand load. In eager PyTorch a dequantise
// then matmul reads the int8 weight, writes a bf16 copy and reads it again,
// which makes int8 decode weights a slowdown; this kernel reads each int8
// weight once.
//
// Computes y[M, N] = (x[M, K] . q[K, N]) * s[N] in bf16: x bf16 row-major,
// q int8 row-major (QDense's [in, out] kernel layout), s the fp32
// per-output-channel scales; the product accumulates in fp32 and the scale
// multiplies the accumulator in the epilogue, before the one rounding to
// bf16. The bias is the caller's (it is added as the reference adds it).
//
// What bounds it on this card: at decode (M = the sampler's batch, up to 64
// rows) it does 2 M flops per weight byte, far below the ~295 flops a byte
// where the tensor cores become the limit, so it is bound by the int8 weight
// bytes; at prefill (M = B x P, thousands of rows) by the tensor cores.
// Design (a simple kernel): one CTA of four warps per BM x 64 output tile
// (BM 64, or 16 for the decode rows), a K loop of 64-deep steps; each step
// stores the x tile (16-byte pieces) and the q tile (16 int8 a thread,
// converted to bf16 and stored transposed, so the B fragments are two 32-bit
// reads) that the previous step loaded into registers, issues the next
// step's loads, then runs mma.sync m16n8k16 over each warp's sub-tile with
// fp32 accumulators, so the loads are in flight during the products. Rows
// past M and the K tail are zero-filled. Split-K for grids too small to fill
// the card (the decode rows): `splits` CTAs share a tile's K range, each
// writes its fp32 partial sums to a workspace, and a second kernel adds them
// in split order (deterministic), scales and rounds. Shapes: K and N
// multiples of 8 and 16 (every width of GPT-2, T5 and the Llama family).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"  // mma_bf16

namespace {

constexpr int BN = 64, BK = 64;
constexpr int NT = 128;      // four warps
constexpr int LDS = BK + 8;  // shared row stride in bf16 (144 bytes: 16-byte aligned rows)

template <int BM, int WARPS_M>
__global__ void __launch_bounds__(NT, 2) int8_weight_matmul_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ s,
    __nv_bfloat16* __restrict__ y, float* __restrict__ part, int M, int N, int K, int k_per_split) {
  constexpr int WARPS_N = 4 / WARPS_M;
  constexpr int MI = BM / WARPS_M / 16, NI = BN / WARPS_N / 8;  // m16 and n8 tiles a warp
  constexpr int XP = BM * (BK / 8), XR = (XP + NT - 1) / NT;    // x pieces of 8 bf16, a thread's
  constexpr int QR = BK * (BN / 16) / NT;                        // q pieces of 16 int8 a thread
  __shared__ __align__(16) __nv_bfloat16 xs[BM][LDS];
  __shared__ __align__(16) __nv_bfloat16 ws[BN][LDS];  // transposed: [n][k]
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int g = lane / 4, c = lane % 4;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  uint4 px[XR], pq[QR];
  auto load = [&](int k0) {
#pragma unroll
    for (int r = 0; r < XR; ++r) {
      const int piece = t + r * NT;
      const int row = piece / (BK / 8), kk = (piece % (BK / 8)) * 8;
      px[r] = make_uint4(0u, 0u, 0u, 0u);
      if (piece < XP && m0 + row < M && k0 + kk < k_end)
        px[r] = *reinterpret_cast<const uint4*>(x + static_cast<long long>(m0 + row) * K + k0 + kk);
    }
#pragma unroll
    for (int r = 0; r < QR; ++r) {
      const int piece = t + r * NT;
      const int kr = piece / 4, nn = (piece % 4) * 16;
      pq[r] = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + kr < k_end && n0 + nn < N)
        pq[r] = *reinterpret_cast<const uint4*>(q + static_cast<long long>(k0 + kr) * N + n0 + nn);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int r = 0; r < XR; ++r) {
      const int piece = t + r * NT;
      if (piece < XP) *reinterpret_cast<uint4*>(&xs[piece / (BK / 8)][(piece % (BK / 8)) * 8]) = px[r];
    }
#pragma unroll
    for (int r = 0; r < QR; ++r) {
      const int piece = t + r * NT;
      const int kr = piece / 4, nn = (piece % 4) * 16;
      const uint32_t w[4] = {pq[r].x, pq[r].y, pq[r].z, pq[r].w};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        // byte j of the 16 (little-endian), sign-extended: no local array by address
        const int8_t b = static_cast<int8_t>((w[j / 4] >> (8 * (j % 4))) & 0xffu);
        ws[nn + j][kr] = __float2bfloat16_rn(static_cast<float>(b));
      }
    }
  };

  if (k_begin < k_end) load(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    store();
    __syncthreads();
    if (k0 + BK < k_end) load(k0 + BK);  // in flight during the products below
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t a[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int r = wm * (MI * 16) + mi * 16 + g;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(&xs[r][ks + 2 * c]);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(&xs[r + 8][ks + 2 * c]);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(&xs[r][ks + 2 * c + 8]);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(&xs[r + 8][ks + 2 * c + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int n = wn * (NI * 8) + ni * 8 + g;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&ws[n][ks + 2 * c]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&ws[n][ks + 2 * c + 8]);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) mma_bf16(acc[mi][ni], a[mi], b0, b1);
      }
    }
    __syncthreads();
  }

  // epilogue: alone, the scale on the fp32 accumulator and one rounding to
  // bf16; under split-K, the unscaled fp32 partial sums of this K range
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int col = n0 + wn * (NI * 8) + ni * 8 + 2 * c;
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * (MI * 16) + mi * 16 + g + h * 8;
        if (row >= M) continue;
        const long long at = static_cast<long long>(row) * N + col;
        if (gridDim.z == 1) {
          *reinterpret_cast<__nv_bfloat162*>(y + at) =
              __floats2bfloat162_rn(acc[mi][ni][2 * h] * s[col], acc[mi][ni][2 * h + 1] * s[col + 1]);
        } else {
          *reinterpret_cast<float2*>(part + blockIdx.z * static_cast<long long>(M) * N + at) =
              make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
        }
      }
    }
  }
}

// y = (sum over the splits, in order, of the partial sums) * s, rounded to bf16
__global__ void __launch_bounds__(256) int8_weight_matmul_reduce_kernel(
    const float* __restrict__ part, const float* __restrict__ s, __nv_bfloat16* __restrict__ y, long long MN,
    int N, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float acc = part[i];
  for (int z = 1; z < splits; ++z) acc += part[z * MN + i];
  y[i] = __float2bfloat16_rn(acc * s[i % N]);
}

template <int BM, int WARPS_M>
int launch(const void* x, const int8_t* q, const float* s, void* y, float* part, int M, int N, int K, int splits,
           cudaStream_t st) {
  // whole 64-deep steps a split (a split past K adds zeros)
  const int k_per_split = ((K + splits - 1) / splits + BK - 1) / BK * BK;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  int8_weight_matmul_kernel<BM, WARPS_M><<<grid, NT, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), q, s, static_cast<__nv_bfloat16*>(y), part, M, N, K, k_per_split);
  if (splits > 1) {
    const long long MN = static_cast<long long>(M) * N;
    int8_weight_matmul_reduce_kernel<<<static_cast<unsigned>((MN + 255) / 256), 256, 0, st>>>(
        part, s, static_cast<__nv_bfloat16*>(y), MN, N, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [M, K] bf16, q [K, N] int8, s [N] fp32, y [M, N] bf16, all contiguous,
// 16-byte aligned; with splits > 1, part an fp32 workspace of splits x M x N
// (the wrapper's `int8_matmul_splits` picks splits). Up to 16 rows take the
// 16-row tile. Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int int8_weight_matmul(const void* x, const int8_t* q, const float* s, void* y, float* part, int M,
                                  int N, int K, int splits, void* stream) {
  if (M < 1 || N < 16 || K < 8 || N % 16 || K % 8 || splits < 1 || (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 16) return launch<16, 1>(x, q, s, y, part, M, N, K, splits, st);
  return launch<64, 2>(x, q, s, y, part, M, N, K, splits, st);
}

extern "C" const char* int8_weight_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
