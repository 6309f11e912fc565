// Helpers shared by the scan kernels (mamba_scan.cu, rglru_scan.cu): loads,
// rounding and stores of the compute dtype in fp32 registers; torch's
// softplus, silu and sigmoid in fp32, written as torch computes them so that
// a value rounded to bf16 lands where torch's does; and the ordered second
// pass of the backward kernels' sums.
#pragma once

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ckio {

// Loads, rounding and stores of the compute dtype, in fp32 registers.
template <typename T>
struct Elt;

template <>
struct Elt<float> {
  static constexpr int kVec = 4;  // values in 16 bytes
  __device__ static float load(const float* p) { return __ldg(p); }
  __device__ static float rnd(float v) { return v; }
  __device__ static void store(float* p, float v) { *p = v; }
  __device__ static void load_vec(const float* p, float* out) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};

template <>
struct Elt<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static float load(const __nv_bfloat16* p) {
    const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
    return __uint_as_float(static_cast<unsigned>(u) << 16);
  }
  __device__ static float rnd(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  __device__ static void load_vec(const __nv_bfloat16* p, float* out) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // little-endian: element 2i is the low half
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// torch's softplus (beta 1, threshold 20), silu and sigmoid, in fp32.
__device__ __forceinline__ float softplus_f(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}
__device__ __forceinline__ float silu_f(float x) { return x / (1.f + expf(-x)); }
__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}

struct View3 {  // element strides of a (B, S, D) operand
  long long b, t, d;
};

// The second pass of the backward kernels' reductions (mamba_scan.cu,
// rglru_scan.cu): out[r*J + j] = the sum over k = 0, 1, ..., K-1, in that
// order, of in[(r*K + k)*J + j]. One thread an output; a fixed order, so
// the same bits on every run (no atomics).
template <int kUnused = 0>
__global__ void __launch_bounds__(256)
ordered_sum_kernel(const float* __restrict__ in, float* __restrict__ out,
                   long long R, long long K, long long J) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= R * J) return;
  const float* q = in + (i / J) * K * J + i % J;
  float v = 0.f;
  for (long long k = 0; k < K; ++k) v += __ldg(q + k * J);
  out[i] = v;
}

inline cudaError_t ordered_sum(const float* in, float* out, long long R,
                               long long K, long long J, cudaStream_t st) {
  const long long blocks = (R * J + 255) / 256;
  if (blocks == 0) return cudaSuccess;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  ordered_sum_kernel<><<<static_cast<unsigned>(blocks), 256, 0, st>>>(
      in, out, R, K, J);
  return cudaGetLastError();
}

}  // namespace ckio
