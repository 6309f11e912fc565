// Mamba-1 selective scan on an NVIDIA Hopper card (sm_90a).
//
// One kernel with a plain C interface (loaded through ctypes by
// repro_torch/kernels/mamba_scan.py). The launcher enqueues on the stream it
// is given, allocates nothing, and returns cudaGetLastError() so that a
// refused launch is reported at the call.
//
// scan_kernel — replaces mamba_scan_pallas (src/repro/kernels/mamba_scan.py,
//   _scan_kernel). Abar, Bx (B,S,D,N) and C (B,S,N), fp32, contiguous:
//     h_t[d,n] = Abar_t[d,n] * h_{t-1}[d,n] + Bx_t[d,n]
//     y_t[d]   = sum_n h_t[d,n] * C_t[n]          -> y (B,S,D) fp32
//   from h_{-1} = h0 (B,D,N) when given, else 0 (the Pallas function), and
//   optionally writes the final state h_{S-1} (B,D,N), which a decode step
//   carries to the next call (S = 1 there).
//
//   Bound: bytes. Every input element is read once and used for one FMA
//   and one product, so the floor is
//     4 * (2*B*S*D*N + B*S*N + B*S*D) bytes (+ 4*B*D*N each for h0 and h_S)
//   over 3.35 TB/s: 17.7 GB -> 5.29 ms at B=8, S=2048, D=8192, N=16, and
//   2.1 MB -> 0.64 us at falcon-mamba's decode shape (B=1, S=1, with h0 and
//   h_S), where the launch (a few us) is the real floor. The 4*B*S*D*N
//   FLOPs are 0.13 ms at the 67 TFLOP/s fp32 rate: far below the bytes.
//
//   Design: the Pallas kernel sweeps the sequence as the sequential grid
//   axis and keeps the carry in VMEM scratch between grid steps. On Hopper
//   no state survives between blocks, so each thread walks t = 0..S-1 in a
//   loop and keeps its state element in a register: a (b, d) channel is a
//   group of N lanes (N <= 32, a power of two, so a group never straddles a
//   warp), lane n holding h[d, n]. Element (b, t, d, n) sits at
//   ((b*S + t)*D + d)*N + n, so at each step a warp's lanes read
//   neighbouring addresses (n fastest, then d): 128 contiguous bytes of
//   Abar and of Bx. C_t is a broadcast of N floats. The sum over n is a
//   butterfly of xor shuffles inside the group: a fixed order, no atomics,
//   so the result is the same on every run (the continuous batcher's
//   tokens must equal the sequential oracle's). The loads do not depend on
//   h, so each thread loads kUnroll steps ahead before it runs them, which
//   keeps 2*kUnroll loads in flight per thread. Offsets are 64-bit: at the
//   bound's shape each input holds 2^31 elements. Groups past the last
//   channel shadow it (same loads, no stores) so that every lane of a warp
//   takes part in the shuffles.
//
//   What it leaves for later: Abar and Bx are built in device memory by the
//   caller (2*B*S*D*N floats); fusing the discretization (exp(dt*A),
//   dt*B*x) into the kernel would read B*S*(D + 2N) instead, 16x fewer
//   bytes at N = 16. No cp.async/TMA staging.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;

// Sum over the N lanes of a group; every lane ends with the same value,
// added in the same order on every run.
template <int N>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = N / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <int N>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const float* __restrict__ A, const float* __restrict__ Bx,
            const float* __restrict__ C, const float* __restrict__ h0,
            float* __restrict__ y, float* __restrict__ hS, long long B,
            long long S, long long D) {
  constexpr int kGroups = kThreads / N;  // channels per block
  const int n = threadIdx.x % N;
  const long long channels = B * D;
  const long long ch =
      static_cast<long long>(blockIdx.x) * kGroups + threadIdx.x / N;
  const bool active = ch < channels;
  const long long c = active ? ch : channels - 1;  // channel c = b*D + d
  const long long b = c / D, d = c % D;

  const long long step = D * N;  // elements between t and t+1
  const float* a_p = A + (b * S * D + d) * N + n;
  const float* x_p = Bx + (b * S * D + d) * N + n;
  const float* c_p = C + b * S * N + n;
  float* y_p = y + b * S * D + d;
  const bool writer = active && n == 0;

  float h = h0 != nullptr ? h0[c * N + n] : 0.f;
  long long t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float a[kUnroll], x[kUnroll], cc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      a[u] = __ldg(a_p + (t + u) * step);
      x[u] = __ldg(x_p + (t + u) * step);
      cc[u] = __ldg(c_p + (t + u) * N);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = fmaf(a[u], h, x[u]);
      const float s = group_sum<N>(h * cc[u]);
      if (writer) y_p[(t + u) * D] = s;
    }
  }
  for (; t < S; ++t) {
    h = fmaf(__ldg(a_p + t * step), h, __ldg(x_p + t * step));
    const float s = group_sum<N>(h * __ldg(c_p + t * N));
    if (writer) y_p[t * D] = s;
  }
  if (hS != nullptr && active) hS[c * N + n] = h;
}

template <int N>
cudaError_t launch(const float* A, const float* Bx, const float* C,
                   const float* h0, float* y, float* hS, long long B,
                   long long S, long long D, cudaStream_t st) {
  constexpr long long kGroups = kThreads / N;
  const long long blocks = (B * D + kGroups - 1) / kGroups;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  scan_kernel<N><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      A, Bx, C, h0, y, hS, B, S, D);
  return cudaGetLastError();
}

}  // namespace

// A, Bx: (B,S,D,N); C: (B,S,N); h0: (B,D,N) or null; y: (B,S,D);
// hS: (B,D,N) or null. All fp32, contiguous, on the stream's device.
extern "C" int ckio_mamba_scan(const float* A, const float* Bx, const float* C,
                               const float* h0, float* y, float* hS,
                               long long B, long long S, long long D, int N,
                               void* stream) {
  if (B < 1 || S < 0 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (N) {
    case 1: err = launch<1>(A, Bx, C, h0, y, hS, B, S, D, st); break;
    case 2: err = launch<2>(A, Bx, C, h0, y, hS, B, S, D, st); break;
    case 4: err = launch<4>(A, Bx, C, h0, y, hS, B, S, D, st); break;
    case 8: err = launch<8>(A, Bx, C, h0, y, hS, B, S, D, st); break;
    case 16: err = launch<16>(A, Bx, C, h0, y, hS, B, S, D, st); break;
    case 32: err = launch<32>(A, Bx, C, h0, y, hS, B, S, D, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
