// RG-LRU linear recurrence on an NVIDIA Hopper card (sm_90a).
//
// One kernel with a plain C interface (loaded through ctypes by
// repro_torch/kernels/rglru_scan.py). The launcher enqueues on the stream it
// is given, allocates nothing, and returns cudaGetLastError() so that a
// refused launch is reported at the call.
//
// lru_kernel — replaces rglru_scan_pallas (src/repro/kernels/rglru_scan.py,
//   _lru_kernel). a, b (B,S,W), fp32, contiguous:
//     h_t[w] = a_t[w] * h_{t-1}[w] + b_t[w]          -> h (B,S,W) fp32
//   from h_{-1} = h0 (B,W) when given, else 0 (the Pallas function). Every
//   h_t is written; h[:, S-1] is the final state, which a decode step
//   carries to the next call (S = 1 there).
//
//   Bound: bytes. Each element of a and b is read once and each h written
//   once, for one FMA: 12*B*S*W bytes (+ 4*B*W for h0) over 3.35 TB/s is
//   503 MB -> 0.150 ms at B=8, S=2048, W=2560, and 31 KB -> 0.009 us at the
//   decode shape (B=1, S=1, W=2560, with h0), where the launch (a few us)
//   is the real floor. The 2*B*S*W FLOPs are 0.0013 ms at 67 TFLOP/s.
//
//   Design: the Pallas kernel sweeps sequence chunks as the sequential grid
//   axis with the carry in VMEM scratch and needs S and W to be multiples
//   of its tiles. On Hopper no state survives between blocks, so each
//   thread owns one (b, w) channel, walks t = 0..S-1 in a loop and keeps h
//   in a register. Element (b, t, w) sits at (b*S + t)*W + w and a thread's
//   w is its neighbour's + 1, so at each step a warp reads 128 contiguous
//   bytes of a and of b and writes 128 of h. Any B, S and W: the last block
//   masks the channels past B*W, and the loop masks the steps past S. The
//   loads do not depend on h: each thread loads the next kUnroll steps of a
//   and b while it runs the current kUnroll (registers, double-buffered),
//   so 2*kUnroll loads stay in flight behind the dependent FMA chain.
//   Offsets are 64-bit. The sum is the same on every run (no atomics).
//
//   What it leaves for later: at B*W = 20,480 channels the grid is 160
//   blocks of 128 threads, about one a SM, and each thread walks all of S;
//   a chunked two-pass scan (chunk-local scans in parallel, then a carry
//   fix-up) would put more loads in flight. At decode it sits at the launch
//   floor.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
lru_kernel(const float* __restrict__ a, const float* __restrict__ b,
           const float* __restrict__ h0, float* __restrict__ h,
           long long B, long long S, long long W) {
  const long long c = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= B * W) return;
  const long long bi = c / W, w = c % W;
  const long long base = bi * S * W + w;  // element (bi, 0, w)
  const float* a_p = a + base;
  const float* b_p = b + base;
  float* h_p = h + base;

  float x = h0 != nullptr ? h0[c] : 0.f;
  float ca[kUnroll], cb[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    ca[u] = u < S ? __ldg(a_p + u * W) : 0.f;
    cb[u] = u < S ? __ldg(b_p + u * W) : 0.f;
  }
  for (long long t = 0; t < S; t += kUnroll) {
    float na[kUnroll], nb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long tn = t + kUnroll + u;
      na[u] = tn < S ? __ldg(a_p + tn * W) : 0.f;
      nb[u] = tn < S ? __ldg(b_p + tn * W) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t + u < S) {
        x = fmaf(ca[u], x, cb[u]);
        h_p[(t + u) * W] = x;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ca[u] = na[u];
      cb[u] = nb[u];
    }
  }
}

}  // namespace

// a, b: (B,S,W); h0: (B,W) or null; h: (B,S,W). All fp32, contiguous, on
// the stream's device.
extern "C" int ckio_rglru_scan(const float* a, const float* b, const float* h0,
                               float* h, long long B, long long S, long long W,
                               void* stream) {
  if (B < 1 || S < 0 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (B * W + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  lru_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(a, b, h0, h, B, S, W);
  return static_cast<int>(cudaGetLastError());
}
