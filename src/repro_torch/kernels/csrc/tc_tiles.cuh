// Tensor-core tile helpers shared by the attention kernels
// (flash_attention.cu, flash_attention_bwd.cu): asynchronous 16-byte
// copies, ldmatrix, mma.sync.m16n8k16 (bf16 in, fp32 accumulate), the
// XOR swizzle of a staged tile and the staging loop itself.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with `full` false nothing is read and the 16
// bytes are zero-filled (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (2 ulp; subnormal results flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Byte offset of 16-byte chunk c of row r in a tile of C chunks a row:
// the chunk index is XORed with the row's place in a 128-byte line, so the
// 8 rows an ldmatrix reads at one logical chunk fall in 8 distinct banks.
template <int C>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int kRowsPerLine = C >= 8 ? 1 : 8 / C;
  constexpr int kMask = (C >= 8 ? 8 : C) - 1;
  return (r * C + (c ^ ((r / kRowsPerLine) & kMask))) * 16;
}

// ROWS rows of HD bf16 into a swizzled tile by NTH threads; rows at or past
// n_valid are zero. row_off(r) is row r's element offset; VEC asks for unit
// dim stride and 16-byte alignment (cp.async), else scalar loads.
template <int HD, int ROWS, bool VEC, int NTH, typename RowOff>
__device__ __forceinline__ void tc_stage(unsigned char* dst, const __nv_bfloat16* src,
                                         long long dim_stride, int n_valid,
                                         RowOff row_off) {
  constexpr int C = HD / 8;
  for (int e = threadIdx.x; e < ROWS * C; e += NTH) {
    const int r = e / C, c = e % C;
    const bool in = r < n_valid;
    unsigned char* d = dst + swz<C>(r, c);
    if constexpr (VEC) {
      cp_async16(d, src + row_off(in ? r : 0) + c * 8, in);
    } else {
      union {
        uint4 u;
        __nv_bfloat16 h[8];
      } x;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        x.h[i] = in ? src[row_off(r) + (c * 8 + i) * dim_stride] : __float2bfloat16(0.f);
      *reinterpret_cast<uint4*>(d) = x.u;
    }
  }
}

}  // namespace
