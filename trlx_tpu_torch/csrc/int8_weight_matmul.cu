// Kernel 10: the W8A16 product of QDense's int8 decode weights, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: trlx_tpu/models/transformer.py's QDense runs
// its int8 branch (`quantize_decode_weights`) as an XLA dot whose int8 ->
// bf16 convert fuses into the operand load. In eager PyTorch a dequantise
// then matmul reads the int8 weight, writes a bf16 copy and reads it again;
// this kernel reads each int8 weight once.
//
// Computes y[M, N] = (x[M, K] . q[K, N]) * s[N] in bf16: x bf16 row-major,
// q int8 row-major (QDense's [in, out] kernel layout), s the fp32
// per-output-channel scales; the product accumulates in fp32 and the scale
// multiplies the accumulator in the epilogue, before the one rounding to
// bf16. The bias is the caller's. No floating-point atomics and no split
// whose order depends on timing: the same inputs give the same bits.
//
// Two routes, chosen by the row count M in the wrapper (`int8_matmul_route`):
//
// "wgmma" (M > 64: the prefills, thousands of rows) is bound by the tensor
// cores (2 M flops a weight byte, far above the ~295 a byte where they
// become the limit). A CTA of three warpgroups computes a 128-column by
// BMX-row output tile (BMX 256, or 128 where 256-row tiles would not give
// the card 132 CTAs; where neither does, a cluster of 2, 4 or 8 CTAs splits
// K and adds its fp32 partial tiles through distributed shared memory in
// rank order, one launch). Warpgroup 0 is the producer: one thread keeps a ring
// of STAGES 64-deep K steps in flight by TMA (the x tile [BMX, 64] bf16 and
// the q tile [64, 128] int8, both in the 128-byte swizzle), each stage on
// a full and an empty mbarrier. Warpgroups 1 and 2 each own 64 output
// channels and run wgmma m64nBMXk16 with the operands swapped, y^T = q^T .
// x^T: the weight tile is the A operand, read from shared memory into
// registers and converted there (int8 -> bf16 is exact: a byte permute
// puts the biased byte into an fp32 2^23 pattern, one fp32 subtract
// leaves the integer, whose upper half is its bf16), and x stays the B
// operand in shared memory, K-major as TMA wrote it. Swapped, the
// converted weights never go back to shared memory (no store, no second
// read, no fence between proxies, as a warpgroup converting into a bf16
// B tile would need), and each weight byte is converted once a CTA. The A registers are double-buffered: the next
// K step's weights load and convert while the current wgmma runs. The
// channels are assigned so that a thread's two A rows (g, g + 8) are two
// neighbouring output channels: its A loads are 16-bit, conflict-free in
// the swizzled tile, and its epilogue writes bf16 pairs. The scale
// multiplies the fp32 accumulator per output channel, then one rounding.
//
// "stream" (M <= 64: the samplers' decode rows) is bound by the int8
// weight bytes (2 M flops a byte). A CTA of eight warps owns BN = 16 or
// 32 output channels over all of K and all M rows (BMD = 8, 16, 32 or 64
// rows, rows past M zero-filled by TMA), so N / BN CTAs cover the card
// without splitting K across CTAs: no fp32 workspace, no second launch.
// One thread keeps a ring of STAGES stages (BKD rows of K: 4 or 8 KB of
// weights each; six stages up to 16 rows, four past that) in flight by
// TMA; the eight warps split each stage's 16-deep steps and run mma.sync
// m16n8k16 with the operands swapped (16 channels by 8 rows), then add
// their partial sums through shared memory in warp order.
//
// Shapes: K a multiple of 8 and N of 16 (TMA's 16-byte strides; every
// width of GPT-2, T5 and the Llama family); the K tail and the ragged
// edges are zero-filled by TMA and masked in the epilogue.

#include <atomic>
#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums (the encoder comes from the driver at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"  // mma_bf16

namespace {

namespace cg = cooperative_groups;

// ---------------------------------------------------------------------------
// shared memory, mbarriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the dynamic shared memory rounded up to 1024 bytes (the 128-byte
// swizzle's period, which TMA and wgmma address from)
__device__ __forceinline__ uint8_t* smem_base_1024() {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t a = smem_u32(smem_raw);
  return smem_raw + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// spins until the phase of parity `parity` has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// a 2-D tile (c0 the inner coordinate) into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// every thread of the cluster (threads may call these from diverged code)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// int8 -> bf16, exactly
// ---------------------------------------------------------------------------

// four int8 bytes b0..b3 -> bf16 pairs (b0, b2) and (b1, b3), low half first.
// b ^ 0x80 is b + 128 as an unsigned byte; 0x4B0000xx is 2^23 + xx in fp32,
// so subtracting 2^23 + 128 leaves b exactly, and an integer of at most 8
// bits has its whole fp32 mantissa in the upper half: that half is its bf16.
__device__ __forceinline__ void int8x4_to_bf16(uint32_t u, uint32_t& even, uint32_t& odd) {
  u ^= 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
  even = __byte_perm(__float_as_uint(f0), __float_as_uint(f2), 0x7632);
  odd = __byte_perm(__float_as_uint(f1), __float_as_uint(f3), 0x7632);
}

// ---------------------------------------------------------------------------
// wgmma (register A, shared-memory B), fp32 accumulators
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// the K-major B operand in the 128-byte swizzle: 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}


template <int BMX>
__device__ __forceinline__ void wgmma_step(float (&d)[BMX / 2], const uint32_t* a, uint64_t desc) {
  if constexpr (BMX == 128) wgmma_m64n128k16(d, a, desc);
  else wgmma_m64n256k16(d, a, desc);
}

// keeps registers as they are up to this point (the async wgmma reads
// its A registers and writes its accumulators until wgmma_wait_all)
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void pin(const uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" ::"r"(a[i]) : "memory");
}

// ---------------------------------------------------------------------------
// the prefill route
// ---------------------------------------------------------------------------

constexpr int WG_BN = 128;  // output channels a CTA: two consumer warpgroups of 64
constexpr int WG_BK = 64;   // K a stage: one 128-byte swizzle row of x

template <int BMX>
struct WgmmaTile {
  static constexpr int STAGES = BMX == 256 ? 4 : 6;
  static constexpr int X_BYTES = BMX * WG_BK * 2;
  static constexpr int Q_BYTES = WG_BK * WG_BN;
  static constexpr int SMEM = STAGES * (X_BYTES + Q_BYTES) + 2 * STAGES * 8 + 1024;
  static_assert(BMX * WG_BN * 4 <= STAGES * (X_BYTES + Q_BYTES), "a split tile's partials must fit in the ring");
};

// a consumer thread's 16 A registers of one 64-deep stage: for each 16-deep
// step s, rows (g, g + 8) = channels (n, n + 1), k = 16 s + 2c (+1, +8, +9)
__device__ __forceinline__ void load_a(uint32_t (&a)[16], const uint8_t* qt, uint32_t off0, uint32_t off1) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const uint32_t w0 = *reinterpret_cast<const uint16_t*>(qt + off0 + 2048 * s);
    const uint32_t w1 = *reinterpret_cast<const uint16_t*>(qt + off1 + 2048 * s);
    const uint32_t w2 = *reinterpret_cast<const uint16_t*>(qt + off0 + 2048 * s + 1024);
    const uint32_t w3 = *reinterpret_cast<const uint16_t*>(qt + off1 + 2048 * s + 1024);
    int8x4_to_bf16(w0 | (w1 << 16), a[4 * s + 0], a[4 * s + 1]);
    int8x4_to_bf16(w2 | (w3 << 16), a[4 * s + 2], a[4 * s + 3]);
  }
}

// one 64-deep stage k on the A registers `cur`, while stage k + 1's weights
// load and convert into `nxt`; then the stage's slot goes back to the
// producer (each of the eight consumer warps arrives once)
template <int BMX, int S>
__device__ __forceinline__ void consume_stage(float (&acc)[BMX / 2], const uint32_t (&cur)[16], uint32_t (&nxt)[16],
                                              int k, int k_end, const uint8_t* xs, const uint8_t* qs, uint64_t* full,
                                              uint64_t* empty, uint32_t off0, uint32_t off1, int lane) {
  const int st = k % S;
  const uint32_t xt = smem_u32(xs + st * WgmmaTile<BMX>::X_BYTES);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 4; ++s) wgmma_step<BMX>(acc, &cur[4 * s], b_desc(xt + 32 * s));
  wgmma_commit();
  pin(acc);
  if (k + 1 < k_end) {
    const int nx = (k + 1) % S;
    bar_wait(&full[nx], ((k + 1) / S) & 1);
    load_a(nxt, qs + nx * WgmmaTile<BMX>::Q_BYTES, off0, off1);
  }
  wgmma_wait_all();
  pin(acc);
  pin(cur);
  __syncwarp();
  if (lane == 0) bar_arrive(&empty[st]);
}

// a K-split tile's epilogue: each CTA of the cluster writes its fp32 partial
// tile [BMX rows][128 channels] over its ring (every stage has landed and
// been read: the first cluster barrier), then CTA r adds rows r BMX /
// splits .. of the `splits` partials in rank order through distributed
// shared memory, scales, rounds once and stores; the last barrier keeps
// each CTA's partials alive until every rank has read them. A thread adds
// four channels (a float4) of four rows at a time, so that four remote
// loads are in flight rather than one.
template <int BMX>
__device__ __forceinline__ void split_epilogue(const float (&acc)[BMX / 2], float* part, int splits, int rank, int j,
                                               int wq, int g, int c, int t, const float* __restrict__ s,
                                               __nv_bfloat16* __restrict__ y, int m0, int n0, int M, int N) {
  cluster_sync();
#pragma unroll
  for (int i = 0; i < BMX / 2; i += 4) {
    const int m = 8 * (i / 4) + 2 * c, n = 64 * j + 16 * wq + 2 * g;
    *reinterpret_cast<float2*>(part + m * WG_BN + n) = make_float2(acc[i], acc[i + 2]);
    *reinterpret_cast<float2*>(part + (m + 1) * WG_BN + n) = make_float2(acc[i + 1], acc[i + 3]);
  }
  cluster_sync();
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int Q = WG_BN / 4, U = 4;  // float4 columns of a row; rows a thread adds at once
  const int rows = BMX / splits, col = t % Q;
  const int n = n0 + 4 * col;
  for (int r0 = rank * rows + t / Q; r0 < (rank + 1) * rows; r0 += U * (256 / Q)) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < splits; ++r) {
      const float* rp = cluster.map_shared_rank(part, r);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int m = r0 + u * (256 / Q);
        if (m < (rank + 1) * rows) {
          const float4 p = *reinterpret_cast<const float4*>(rp + m * WG_BN + 4 * col);
          v[u].x += p.x;
          v[u].y += p.y;
          v[u].z += p.z;
          v[u].w += p.w;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int m = r0 + u * (256 / Q);
      if (m >= (rank + 1) * rows || m0 + m >= M || n >= N) continue;
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[u].x * s[n], v[u].y * s[n + 1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[u].z * s[n + 2], v[u].w * s[n + 3]);
      uint2 out;
      out.x = *reinterpret_cast<const uint32_t*>(&lo);
      out.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(y + static_cast<long long>(m0 + m) * N + n) = out;
    }
  }
  cluster_sync();
}

// grid (column tiles x splits, row tiles), clusters of `splits` CTAs along
// x: CTA rank r of a cluster takes the r-th share of the K stages
template <int BMX>
__global__ void __launch_bounds__(384, 1) w8a16_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                                                             const __grid_constant__ CUtensorMap qmap,
                                                             const float* __restrict__ s,
                                                             __nv_bfloat16* __restrict__ y, int M, int N, int K,
                                                             int splits) {
  using T = WgmmaTile<BMX>;
  constexpr int S = T::STAGES;
  uint8_t* smem = smem_base_1024();
  uint8_t* xs = smem;
  uint8_t* qs = smem + S * T::X_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(qs + S * T::Q_BYTES);
  uint64_t* empty = full + S;
  const int rank = blockIdx.x % splits;
  const int n0 = blockIdx.x / splits * WG_BN, m0 = blockIdx.y * BMX;
  // the rank's stages [kt_begin, kt_begin + n_st): whole 64-deep stages,
  // so only the last one that reaches K reads past it (as zeros)
  const int stages = (K + WG_BK - 1) / WG_BK, per = (stages + splits - 1) / splits;
  const int kt_begin = rank * per, n_st = max(0, min(stages, kt_begin + per) - kt_begin);
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < S; ++i) {
      bar_init(&full[i], 1);
      bar_init(&empty[i], 8);  // the eight consumer warps
    }
    bar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int i = 0; i < n_st; ++i) {
        const int st = i % S, kk = (kt_begin + i) * WG_BK;
        bar_wait(&empty[st], ((i / S) & 1) ^ 1);
        bar_expect_tx(&full[st], T::X_BYTES + T::Q_BYTES);
        tma_load(xs + st * T::X_BYTES, &xmap, &full[st], kk, m0);
        tma_load(qs + st * T::Q_BYTES, &qmap, &full[st], n0, kk);
      }
    }
    if (splits > 1)
      for (int i = 0; i < 3; ++i) cluster_sync();  // split_epilogue's three
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int j = wg - 1;  // channels n0 + 64 j .. + 63
    const int t = threadIdx.x - 128;  // 0 .. 255 over both consumer warpgroups
    const int wq = (t % 128) / 32, lane = t % 32, g = lane / 4, c = lane % 4;
    // the thread's channel pair n, n + 1 (A rows 16 wq + g and + 8) lies in
    // 16-byte chunk 4 j + wq of each 128-byte q row; the swizzle moves
    // chunk x of row k to x ^ (k % 8), and k % 8 is 2c or 2c + 1
    const int chunk = 4 * j + wq;
    const uint32_t off0 = (2 * c) * 128 + ((chunk ^ (2 * c)) << 4) + 2 * g;
    const uint32_t off1 = (2 * c + 1) * 128 + ((chunk ^ (2 * c + 1)) << 4) + 2 * g;
    float acc[BMX / 2];
#pragma unroll
    for (int i = 0; i < BMX / 2; ++i) acc[i] = 0.f;
    uint32_t a0[16], a1[16];
    if (n_st > 0) {
      bar_wait(&full[0], 0);
      load_a(a0, qs, off0, off1);
    }
    for (int kt = 0; kt < n_st; kt += 2) {
      consume_stage<BMX, S>(acc, a0, a1, kt, n_st, xs, qs, full, empty, off0, off1, lane);
      if (kt + 1 < n_st) consume_stage<BMX, S>(acc, a1, a0, kt + 1, n_st, xs, qs, full, empty, off0, off1, lane);
    }
    if (splits > 1) {
      split_epilogue<BMX>(acc, reinterpret_cast<float*>(smem), splits, rank, j, wq, g, c, t, s, y, m0, n0, M, N);
      return;
    }
    // epilogue: accumulator i (of 4 a column group) is channel n (+1 for
    // i % 4 >= 2), row m0 + 8 (i / 4) + 2c (+1 for odd i)
    const int n = n0 + 64 * j + 16 * wq + 2 * g;
    if (n < N) {
      const float s0 = s[n], s1 = s[n + 1];
#pragma unroll
      for (int i = 0; i < BMX / 8; ++i) {
        const int m = m0 + 8 * i + 2 * c;
        if (m < M)
          *reinterpret_cast<__nv_bfloat162*>(y + static_cast<long long>(m) * N + n) =
              __floats2bfloat162_rn(acc[4 * i] * s0, acc[4 * i + 2] * s1);
        if (m + 1 < M)
          *reinterpret_cast<__nv_bfloat162*>(y + static_cast<long long>(m + 1) * N + n) =
              __floats2bfloat162_rn(acc[4 * i + 1] * s0, acc[4 * i + 3] * s1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the decode route
// ---------------------------------------------------------------------------

constexpr int ST_WARPS = 8;

template <int BMD, int BN>
struct StreamTile {
  static constexpr int BKD = BMD <= 16 ? 256 : 128;  // K a stage
  static constexpr int STAGES = BMD <= 16 ? 6 : 4;
  static constexpr int X_BYTES = BMD * BKD * 2;  // BKD / 64 boxes of [BMD, 64] bf16
  static constexpr int Q_BYTES = BKD * BN;
  static constexpr int RING = STAGES * (X_BYTES + Q_BYTES);
  static constexpr int SMEM = RING + STAGES * 8 + 1024;
  // the warps' partial sums reuse the ring
  static_assert(ST_WARPS * BN * BMD * 4 <= RING, "the reduction must fit in the ring");
};

template <int BMD, int BN>
__global__ void __launch_bounds__(ST_WARPS * 32) w8a16_stream_kernel(const __grid_constant__ CUtensorMap xmap,
                                                                    const __grid_constant__ CUtensorMap qmap,
                                                                    const float* __restrict__ s,
                                                                    __nv_bfloat16* __restrict__ y, int M, int N,
                                                                    int K) {
  using T = StreamTile<BMD, BN>;
  constexpr int S = T::STAGES, BKD = T::BKD;
  constexpr int NBLK = BN / 16, NB = BMD / 8;  // m16 channel blocks, n8 row blocks
  uint8_t* smem = smem_base_1024();
  uint8_t* xs = smem;
  uint8_t* qs = smem + S * T::X_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::RING);
  const int n0 = blockIdx.x * BN;
  const int kt_end = (K + BKD - 1) / BKD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;

  auto issue = [&](int kt) {
    const int st = kt % S;
    bar_expect_tx(&full[st], T::X_BYTES + T::Q_BYTES);
#pragma unroll
    for (int b = 0; b < BKD / 64; ++b)
      tma_load(xs + st * T::X_BYTES + b * BMD * 128, &xmap, &full[st], kt * BKD + 64 * b, 0);
    tma_load(qs + st * T::Q_BYTES, &qmap, &full[st], n0, kt * BKD);
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < S; ++i) bar_init(&full[i], 1);
    bar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int kt = 0; kt < S && kt < kt_end; ++kt) issue(kt);

  float acc[NBLK][NB][4];
#pragma unroll
  for (int i = 0; i < NBLK; ++i)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][nb][r] = 0.f;

  for (int kt = 0; kt < kt_end; ++kt) {
    const int st = kt % S;
    bar_wait(&full[st], (kt / S) & 1);
    const uint8_t* qt = qs + st * T::Q_BYTES;
    const uint8_t* xt = xs + st * T::X_BYTES;
#pragma unroll
    for (int i = 0; i < BKD / 16 / ST_WARPS; ++i) {
      const int ks = warp + ST_WARPS * i;  // the warp's 16-deep step in the stage
      const int kr = 16 * ks + 2 * c;
      // A: the thread's channels are 2 NBLK consecutive bytes of each q row
      // (block i rows g, g + 8 -> channels (BN / 8) g + 2 i, + 1)
      uint32_t a[NBLK][4];
      if constexpr (NBLK == 1) {
        const uint32_t w0 = *reinterpret_cast<const uint16_t*>(qt + kr * BN + 2 * g);
        const uint32_t w1 = *reinterpret_cast<const uint16_t*>(qt + (kr + 1) * BN + 2 * g);
        const uint32_t w2 = *reinterpret_cast<const uint16_t*>(qt + (kr + 8) * BN + 2 * g);
        const uint32_t w3 = *reinterpret_cast<const uint16_t*>(qt + (kr + 9) * BN + 2 * g);
        int8x4_to_bf16(w0 | (w1 << 16), a[0][0], a[0][1]);
        int8x4_to_bf16(w2 | (w3 << 16), a[0][2], a[0][3]);
      } else {
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(qt + kr * BN + 4 * g);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(qt + (kr + 1) * BN + 4 * g);
        const uint32_t w2 = *reinterpret_cast<const uint32_t*>(qt + (kr + 8) * BN + 4 * g);
        const uint32_t w3 = *reinterpret_cast<const uint32_t*>(qt + (kr + 9) * BN + 4 * g);
        int8x4_to_bf16(__byte_perm(w0, w1, 0x5410), a[0][0], a[0][1]);
        int8x4_to_bf16(__byte_perm(w2, w3, 0x5410), a[0][2], a[0][3]);
        int8x4_to_bf16(__byte_perm(w0, w1, 0x7632), a[1][0], a[1][1]);
        int8x4_to_bf16(__byte_perm(w2, w3, 0x7632), a[1][2], a[1][3]);
      }
      // B: x rows 8 nb + g, k = kr .. + 1 and kr + 8 .. + 9, in box ks / 4,
      // chunk 2 (ks % 4) (+1) swizzled by the row's g
      const uint8_t* xb = xt + (ks / 4) * BMD * 128;
      const int ch = 2 * (ks % 4);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const uint8_t* row = xb + (8 * nb + g) * 128;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(row + ((ch ^ g) << 4) + 4 * c);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(row + (((ch + 1) ^ g) << 4) + 4 * c);
#pragma unroll
        for (int blk = 0; blk < NBLK; ++blk) mma_bf16(acc[blk][nb], a[blk], b0, b1);
      }
    }
    __syncthreads();  // every warp is done with stage st
    if (threadIdx.x == 0 && kt + S < kt_end) issue(kt + S);
  }

  // the warps' partial sums [warp][channel][row] over the ring (every TMA
  // has landed: each stage's barrier was waited on), then each output is
  // their sum in warp order, scaled and rounded once
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int blk = 0; blk < NBLK; ++blk)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ch = (BN / 8) * g + 2 * blk + r / 2, m = 8 * nb + 2 * c + r % 2;
        red[(warp * BN + ch) * BMD + m] = acc[blk][nb][r];
      }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BMD * (BN / 2); idx += ST_WARPS * 32) {
    const int m = idx / (BN / 2), ch = 2 * (idx % (BN / 2));
    if (m >= M || n0 + ch >= N) continue;
    float v0 = 0.f, v1 = 0.f;
#pragma unroll
    for (int w = 0; w < ST_WARPS; ++w) {
      v0 += red[(w * BN + ch) * BMD + m];
      v1 += red[(w * BN + ch + 1) * BMD + m];
    }
    *reinterpret_cast<__nv_bfloat162*>(y + static_cast<long long>(m) * N + n0 + ch) =
        __floats2bfloat162_rn(v0 * s[n0 + ch], v1 * s[n0 + ch + 1]);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                                            &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major [rows, cols] matrix of `elem` bytes an element, read in
// [box_rows, box_cols] tiles; out-of-bounds elements read as zeros
bool tensor_map(CUtensorMap* map, const void* base, CUtensorMapDataType type, int elem, int rows, int cols,
                int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int MAX_DEVICES = 64;

// lets `kernel` take `bytes` of dynamic shared memory on the current device,
// once a device: `done` is the calling instantiation's own flags (the
// attribute lasts in the device's context, and setting it costs host time a
// launch)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < MAX_DEVICES && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc == cudaSuccess && dev < MAX_DEVICES) done[dev].store(true, std::memory_order_release);
  return rc;
}

template <int BMX>
int launch_wgmma(const void* x, const int8_t* q, const float* s, void* y, int M, int N, int K, int splits,
                 cudaStream_t st) {
  using T = WgmmaTile<BMX>;
  CUtensorMap xmap, qmap;
  if (!tensor_map(&xmap, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, BMX, WG_BK, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&qmap, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N, WG_BK, WG_BN, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<bool> smem_set[MAX_DEVICES];
  const cudaError_t attr = allow_smem(w8a16_wgmma_kernel<BMX>, T::SMEM, smem_set);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + WG_BN - 1) / WG_BN * splits, (M + BMX - 1) / BMX);
  cfg.blockDim = dim3(384);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = splits;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, w8a16_wgmma_kernel<BMX>, xmap, qmap, s,
                                            static_cast<__nv_bfloat16*>(y), M, N, K, splits);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

template <int BMD, int BN>
int launch_stream(const void* x, const int8_t* q, const float* s, void* y, int M, int N, int K, cudaStream_t st) {
  using T = StreamTile<BMD, BN>;
  CUtensorMap xmap, qmap;
  if (!tensor_map(&xmap, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, BMD, 64, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&qmap, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N, T::BKD, BN, CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<bool> smem_set[MAX_DEVICES];
  const cudaError_t attr = allow_smem(w8a16_stream_kernel<BMD, BN>, T::SMEM, smem_set);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  w8a16_stream_kernel<BMD, BN><<<(N + BN - 1) / BN, ST_WARPS * 32, T::SMEM, st>>>(
      xmap, qmap, s, static_cast<__nv_bfloat16*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_stream_rows(int rows, const void* x, const int8_t* q, const float* s, void* y, int M, int N, int K,
                       cudaStream_t st) {
  switch (rows) {
    case 8: return launch_stream<8, BN>(x, q, s, y, M, N, K, st);
    case 16: return launch_stream<16, BN>(x, q, s, y, M, N, K, st);
    case 32: return launch_stream<32, BN>(x, q, s, y, M, N, K, st);
    case 64: return launch_stream<64, BN>(x, q, s, y, M, N, K, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x [M, K] bf16, q [K, N] int8, s [N] fp32, y [M, N] bf16, all contiguous
// and 16-byte aligned. route 0 ("stream"): `rows` (8, 16, 32 or 64, at
// least M) by `cols` (16 or 32) tiles, `splits` 1; route 1 ("wgmma"):
// `rows` (128 or 256) by 128 tiles (`cols` 128), K split over clusters of
// `splits` (1, 2, 4 or 8) CTAs. The wrapper's `int8_matmul_route` picks
// them. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape or tiling the kernels do not take.
extern "C" int int8_weight_matmul(const void* x, const int8_t* q, const float* s, void* y, int M, int N, int K,
                                  int route, int rows, int cols, int splits, void* stream) {
  if (M < 1 || N < 16 || K < 8 || N % 16 || K % 8) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 0 && splits == 1) {
    if (M > rows) return static_cast<int>(cudaErrorInvalidValue);
    if (cols == 16) return launch_stream_rows<16>(rows, x, q, s, y, M, N, K, st);
    if (cols == 32) return launch_stream_rows<32>(rows, x, q, s, y, M, N, K, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route == 1 && cols == WG_BN && (splits == 1 || splits == 2 || splits == 4 || splits == 8)) {
    if (rows == 128) return launch_wgmma<128>(x, q, s, y, M, N, K, splits, st);
    if (rows == 256) return launch_wgmma<256>(x, q, s, y, M, N, K, splits, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* int8_weight_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
