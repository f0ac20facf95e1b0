// mma.sync m16n8k16 helpers shared by the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu, flash_bias_fwd.cu, flash_bias_bwd.cu):
// bf16 packing, the tensor-core product, the fragment loads (by hand,
// and by ldmatrix from shared memory); and, for those and the decode
// kernels (paged_attention.cu, decode_int8.cu), the cp.async copies into
// shared memory and the int8 -> float conversion by byte permute.
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, c = lane % 4):
//   A reg0: row g,   k 2c..2c+1   reg1: row g+8, k 2c..2c+1
//     reg2: row g,   k 2c+8..+9   reg3: row g+8, k 2c+8..+9
//   B reg0: k 2c..2c+1, col g     reg1: k 2c+8..+9, col g
//   C/D [0,1]: row g, cols 2c..2c+1   [2,3]: row g+8, cols 2c..2c+1
// So the accumulators of two neighbouring 8-column tiles are exactly the A
// fragment of one 16-deep k-step (pack_acc below).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

// 16 rows of a [rows, D] bf16 matrix (rows row0.. of this warp, zero where
// `ok` is false for the row) as the A fragments of the D/16 k-steps
template <int D>
__device__ __forceinline__ void load_a_rows(uint32_t (&f)[D / 16][4],
                                            const __nv_bfloat16* base, long long stride,
                                            int row0, bool ok0, bool ok1, int c) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const bool ok = (r & 1) ? ok1 : ok0;
      const int row = row0 + (r & 1) * 8;
      const int col = kk * 16 + c * 2 + (r >> 1) * 8;
      f[kk][r] = ok ? *reinterpret_cast<const uint32_t*>(base + row * stride + col) : 0u;
    }
  }
}

// ldmatrix: four 8 x 8 bf16 matrices from shared memory, lane l giving the
// address of row l % 8 of matrix l / 8 (16-byte aligned); register i holds
// matrix i as the mma fragments do (.trans: transposed)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// The fragments below come from a bf16 tile t_s [rows][LD] in shared memory
// (LD * 2 bytes a multiple of 16) by one ldmatrix each; `lane` is the
// thread's lane.
// A fragment of k-step kk over tile rows row0.. (16 rows; k = tile columns)
template <int LD>
__device__ __forceinline__ void ldm_a(uint32_t (&a)[4], const __nv_bfloat16* t_s, int row0, int kk,
                                      int lane) {
  ldmatrix_x4(a, t_s + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + kk * 16 + (lane >> 4) * 8);
}

// A fragment of the TRANSPOSED tile: A rows = tile columns col0.. (16), A
// depth k = tile rows kk * 16..
template <int LD>
__device__ __forceinline__ void ldm_a_trans(uint32_t (&a)[4], const __nv_bfloat16* t_s, int col0, int kk,
                                            int lane) {
  ldmatrix_x4_trans(a, t_s + (kk * 16 + (lane & 7) + (lane >> 4) * 8) * LD + col0 + ((lane >> 3) & 1) * 8);
}

// B fragments of n-tiles n and n + 1 with k = tile rows kk * 16.. and n =
// tile columns (8 each): b[0], b[1] for tile n, b[2], b[3] for tile n + 1
template <int LD>
__device__ __forceinline__ void ldm_b_rows(uint32_t (&b)[4], const __nv_bfloat16* t_s, int kk, int n,
                                           int lane) {
  ldmatrix_x4_trans(b, t_s + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (n + (lane >> 4)) * 8);
}

// B fragments of n-tiles n and n + 1 with k = tile columns ks * 16.. and n =
// tile rows (8 each), laid out as ldm_b_rows'
template <int LD>
__device__ __forceinline__ void ldm_b_cols(uint32_t (&b)[4], const __nv_bfloat16* t_s, int ks, int n,
                                           int lane) {
  ldmatrix_x4(b, t_s + ((n + (lane >> 4)) * 8 + (lane & 7)) * LD + ks * 16 + ((lane >> 3) & 1) * 8);
}

// 16 bytes global -> shared, asynchronously; zero-filled (nothing read)
// when `ok` is false
__device__ __forceinline__ void cp_async16(void* dst_s, const void* src, bool ok) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(dst_s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(ok ? 16 : 0));
}

// 4 bytes global -> shared, asynchronously; zero-filled (nothing read)
// when `ok` is false
__device__ __forceinline__ void cp_async4(void* dst_s, const void* src, bool ok) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(dst_s));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// close the thread's group of cp.async copies issued since the last one; wait
// until at most N of its groups are still in flight
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait_group() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// acc[n] (16 x 8 fp32 tiles 2kk and 2kk+1) -> the bf16 A fragment of k-step kk
__device__ __forceinline__ void pack_acc(uint32_t (&a)[4], const float (&x0)[4],
                                         const float (&x1)[4]) {
  a[0] = pack_f32(x0[0], x0[1]);
  a[1] = pack_f32(x0[2], x0[3]);
  a[2] = pack_f32(x1[0], x1[1]);
  a[3] = pack_f32(x1[2], x1[3]);
}

__device__ __forceinline__ float bf16_rest(float x) {
  return x - __bfloat162float(__float2bfloat16_rn(x));
}

// as pack_acc, split in two bf16 fragments whose sum carries 16 bits of each
// value: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void pack_acc_split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                               const float (&x0)[4], const float (&x1)[4]) {
  pack_acc(hi, x0, x1);
  lo[0] = pack_f32(bf16_rest(x0[0]), bf16_rest(x0[1]));
  lo[1] = pack_f32(bf16_rest(x0[2]), bf16_rest(x0[3]));
  lo[2] = pack_f32(bf16_rest(x1[0]), bf16_rest(x1[1]));
  lo[3] = pack_f32(bf16_rest(x1[2]), bf16_rest(x1[3]));
}

// out = 16 x 8 tiles over the rows of `rows_s` (shared, [64][LDS]) chunk kk:
// B fragment with k = row (16 rows kk*16..), n = 8 channels from col n*8
template <int LDS>
__device__ __forceinline__ void b_from_rows(const __nv_bfloat16* rows_s, int kk, int n, int g,
                                            int c, uint32_t& b0, uint32_t& b1) {
  const __nv_bfloat16* p = rows_s + (kk * 16 + c * 2) * LDS + n * 8 + g;
  b0 = pack_bf16(p[0], p[LDS]);
  b1 = pack_bf16(p[8 * LDS], p[9 * LDS]);
}

// B fragment with k = channel (16 channels from ks*16), n = 8 rows from n*8
template <int LDS>
__device__ __forceinline__ void b_from_cols(const __nv_bfloat16* rows_s, int ks, int n, int g,
                                            int c, uint32_t& b0, uint32_t& b1) {
  const __nv_bfloat16* p = rows_s + (n * 8 + g) * LDS + ks * 16 + c * 2;
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}

// Signed byte i of w as a float, exactly: with b ^ 0x80 = b + 128 in the low
// mantissa bits of 2^23, the float is 2^23 + 128 + b. `w` has had its bytes'
// top bits flipped (w ^ 0x80808080). A byte permute and one add, where the
// conversion unit (static_cast) converts only 16 values a clock an SM.
__device__ __forceinline__ float byte_to_float(uint32_t flipped, int i) {
  return __int_as_float(__byte_perm(flipped, 0x4B000000u, 0x7440 + i)) - 8388736.f;
}

}  // namespace
