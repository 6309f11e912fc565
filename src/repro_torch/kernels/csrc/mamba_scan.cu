// Mamba-1 selective scan on an NVIDIA Hopper card (sm_90a), literal and
// fused.
//
// Two entries with a plain C interface (loaded through ctypes by
// repro_torch/kernels/mamba_scan.py): ckio_mamba_scan launches scan_kernel,
// ckio_mamba_scan_fused launches fused_kernel (S > 1) or fused_step_kernel
// (S = 1). The launchers enqueue on the stream they are given, allocate
// nothing, and return cudaGetLastError() so that a refused launch is
// reported at the call.
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
//   The literal entry is the parity counterpart of the Pallas function and
//   runs the "materialized" prefill; the served decode path runs the fused
//   entry below.
//
// fused_kernel, fused_step_kernel — the same scan with the discretization
//   and the output epilogue fused in: the reference's _fused_chunk_scan
//   (src/repro/models/ssm.py) followed by its skip and gate. In the compute
//   dtype T (bf16 or fp32), from xin, dt_pre, z (B,S,D) and proj
//   (B,S,r+2N), each read through its own strides (z is a view of the
//   in_proj output, xin is channel-major as the conv leaves it, Bc and Cc
//   are proj's last 2N columns), and fp32 dt_bias (D), A_log (D,N), Dskip
//   (D), h0 (B,D,N):
//     dt   = float(rnd(softplus(rnd(dt_pre + rnd(dt_bias)))))
//     Abar = exp(dt * -exp(A_log)),  Bx = (dt * Bc) * xin
//     h    = fma(Abar, h, Bx),       y32 = sum_n h * Cc
//     y    = rnd(rnd(rnd(y32) + rnd(rnd(Dskip) * xin)) * rnd(silu(z)))
//   -> y (B,S,D) in T and optionally h_S (B,D,N) fp32. rnd rounds to T
//   (the identity in fp32) where torch rounds between two ops, and every
//   product and sum that torch rounds is written __fmul_rn / __fadd_rn so
//   that nvcc does not contract it into an FMA that torch does not do;
//   softplus and silu round to bf16 exactly as torch's do (all 65,536
//   inputs, tests/test_torch_cuda_kernels.py), and expf is torch's exp. A
//   decode step so gives the bits of the unfused layer (torch ops around
//   scan_kernel), which matters: over 64 bf16 layers, ex2.approx's 2 ulp
//   in Abar moved the decode replay's logits from 3.6e-2 to 5.2e-2 of the
//   prefill forward's (relative L2; chip_smoke.py holds them to 5e-2).
//
//   Bound: both sides. Bytes: xin, dt_pre, z and y once each (2 B a value
//   in bf16), Bc/Cc, the parameters and h0/h_S: 1.07 GB -> 0.32 ms at
//   B=8, S=2048, D=8192, N=16. Special-function units: one ex2 for Abar per
//   (b,t,d,n) and four (softplus' ex2 and lg2, silu's ex2 and rcp) per
//   (b,t,d), 2.68e9 at that shape, at 16 a clock an SM: 0.64 ms on 132 SMs
//   at 1.98 GHz. The layer's elementwise ops before this kernel built Abar
//   and Bx (8.6 GB each at that shape) in device memory.
//
//   Design (fused_kernel, S > 1): a block owns G channels (b, d0..d0+G-1)
//   of one batch row; a channel is a group of L = N/2 lanes, lane l holding
//   h[d, l] and h[d, l + L] in registers (two independent chains a lane,
//   and half the shared-memory reads and shuffles a state), and walks the
//   sequence in tiles of R = 2N steps. For each tile the block
//   (1) stages in shared memory, with loads that run along d, (dt, xin)
//   and silu(z) for R x G (t, d) pairs, each computed once and not once a
//   lane, and the R rows of Bc and Cc, which every channel of the block
//   shares; the next tile's loads are issued before (2), into registers;
//   (2) runs the R steps L rows at a time from registers and shared
//   memory, A computed once a state; the L rows' sums over the
//   group are reduced together (reduce_rows: L - 1 shuffles for L rows,
//   against L log2 L for a butterfly a row), lane l parking row l's y32;
//   (3) writes the epilogue's y along d. (dt, xin) and silu(z) are
//   double-buffered so that (1) of the next tile needs no barrier after
//   (3). Tiles but the last run their rows with no bounds checks. Every
//   sum is in a fixed order, so a row has the same bits at every B and on
//   every run.
//
//   Loads. Where every run of V = 16/sizeof(T) values starts 16-byte
//   aligned (N <= 16, D a multiple of V, unit strides along the run; the
//   served prefill's views are), fused_kernel<N, T, true> reads dt_pre and
//   z along d and xin along d or, as the conv leaves it (channel-major),
//   along t, one 16-byte load a run, and copies the tile's Bc/Cc rows into
//   shared memory with cp.async, a tile ahead. The runs are dealt out by
//   warp: dt's (softplus) on some warps, z's (silu) and xin's on the
//   others. Otherwise (odd proj rows, ragged D, the small test configs)
//   fused_kernel<N, T, false> loads one value at a time. Both give the
//   same bits. At B=8, S=2048, D=8192, N=16, bf16 on an H100 the 16-byte
//   path takes 2.41 ms against 3.00 with channel-major xin (2.47 against
//   2.76 contiguous); with no loads at all the kernel takes 2.05 ms.
//
//   Design (fused_step_kernel, S = 1, every decode step): scan_kernel's
//   layout, a group of N lanes a channel, every lane computing the
//   channel's dt and silu(z) itself (one step has no tile to share them
//   over, and a lane's own copy costs no latency), the butterfly N-sum,
//   lane 0 writing y: one short chain, at the launch floor.
//
#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_math.cuh"

namespace {

using ckio::Elt;
using ckio::silu_f;
using ckio::softplus_f;
using ckio::View3;

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

// -- fused entry --------------------------------------------------------------
struct FusedArgs {
  const void* xin;
  const void* dtp;
  const void* z;
  const void* proj;
  const float* dt_bias;
  const float* A_log;
  const float* Dskip;
  const float* h0;
  void* y;
  float* hS;
  long long B, S, D, r;
  View3 sx, sdt, sz, sp;
  int x_t;  // fused_kernel's 16-byte path: xin read along t (1) or d (0)
};

template <int N>
struct FusedShape {
  static constexpr int kS = N >= 2 ? 2 : 1;  // states a lane: n and n + kL
  static constexpr int kL = N / kS;          // lanes a channel
  static constexpr int kG = 256 / kL < 32 ? 256 / kL : 32;  // channels a block
  static constexpr int kThreads = kG * kL;
  static constexpr int kRows = 2 * N;                       // steps a tile
  // (t, d) pairs a thread stages and finishes a tile, and Bc/Cc values.
  static constexpr int kItems = kRows * kG / kThreads;
  static constexpr int kBC = (2 * N * kRows + kThreads - 1) / kThreads;
};

// The 16-byte path of fused_kernel: V values of T a vector. Each of
// dt_pre, z and xin is kRows x kG values a tile, kNV vectors, dealt out
// over the block (kJobs a thread); a row of Bc/Cc is kCPR vectors, copied
// by cp.async (kCopies a thread).
template <int N, typename T>
struct FusedVec {
  using Sh = FusedShape<N>;
  static constexpr int V = 16 / static_cast<int>(sizeof(T));
  // N = 32's tiles (64 steps) with s_raw would pass 48 KB of shared memory.
  static constexpr bool kOk = N <= 16 && (2 * N) % V == 0 && Sh::kG % V == 0;
  static constexpr int kNV = Sh::kRows * Sh::kG / V;
  // xin's slot of jobs: after an idle one where that puts it on the
  // warps that stage z, away from dt's softplus.
  static constexpr int kXin = 2 * kNV <= Sh::kThreads ? 3 : 2;
  static constexpr int kJobs =
      ((kXin + 1) * kNV + Sh::kThreads - 1) / Sh::kThreads;
  static constexpr int kCPR = kOk ? 2 * N / V : 1;
  static constexpr int kCopies =
      (Sh::kRows * kCPR + Sh::kThreads - 1) / Sh::kThreads;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes from global to shared memory, or 16 zero bytes when !full.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Value e of a 16-byte vector of T, in fp32.
template <typename T>
__device__ __forceinline__ float unpack(const uint4& u, int e) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
  if constexpr (sizeof(T) == 2) {  // little-endian: 2i is the low half
    return __uint_as_float(e % 2 ? w[e / 2] & 0xffff0000u : w[e / 2] << 16);
  } else {
    return __uint_as_float(w[e]);
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The group-sum of L rows at once: lane l holds p[u] for row u of its
// channel and ends with the sum over its L lanes for row l in p[0]. Each
// stage halves the rows a lane holds, handing the other half to the lane
// `o` away: L - 1 shuffles for L rows where a butterfly a row takes
// L log2 L, in a fixed order, so the bits are the same on every run.
template <int L>
__device__ __forceinline__ void reduce_rows(float (&p)[L], int l) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) {
    const bool upper = (l & o) != 0;
#pragma unroll
    for (int k = 0; k < o; ++k) {
      const float send = upper ? p[k] : p[k + o];
      const float keep = upper ? p[k + o] : p[k];
      p[k] = keep + __shfl_xor_sync(kFull, send, o);
    }
  }
}

// kVec: the 16-byte path (FusedVec, chosen by the launcher when every run
// of V values is 16-byte aligned). Otherwise one load a value.
template <int N, typename T, bool kVec>
__global__ void __launch_bounds__(FusedShape<N>::kThreads)
fused_kernel(const FusedArgs p) {
  using E = Elt<T>;
  using Sh = FusedShape<N>;
  using Vc = FusedVec<N, T>;
  constexpr int G = Sh::kG, kT = Sh::kThreads, R = Sh::kRows;
  constexpr int kS = Sh::kS, L = Sh::kL;
  constexpr int kItems = Sh::kItems, kBC = Sh::kBC;
  constexpr int V = Vc::V, kNV = Vc::kNV;
  // (dt, xin) and silu(z) of a tile, double-buffered: the epilogue of one
  // tile reads them while the next is staged (a row padded by one, so that
  // the 16-byte path's stores spread over the banks). (Bc, Cc) of a lane's
  // kS states side by side, and y32, are read only between two barriers.
  // The 16-byte path copies the raw rows of Bc/Cc into s_raw, a tile
  // ahead, and stages dt_bias once.
  __shared__ float2 s_dx[2][R][G + 1];
  __shared__ float s_sz[2][R][G + 1];
  __shared__ float2 s_bc[R][L][kS];
  __shared__ float s_y[R][G];
  __shared__ uint4 s_raw[kVec ? 2 : 1][kVec ? R * Vc::kCPR : 1];
  __shared__ float s_bias[kVec ? G : 1];

  const T* xin = static_cast<const T*>(p.xin);
  const T* dtp = static_cast<const T*>(p.dtp);
  const T* z = static_cast<const T*>(p.z);
  const T* proj = static_cast<const T*>(p.proj);
  T* y = static_cast<T*>(p.y);
  const int tid = threadIdx.x;
  const int g = tid / L, l = tid % L;
  const long long b = blockIdx.y, D = p.D, S = p.S;
  const long long d0 = static_cast<long long>(blockIdx.x) * G;
  const bool active = d0 + g < D;
  const long long dc = active ? d0 + g : D - 1;  // shadow the last channel
  float A[kS], h[kS];  // states l and l + L
#pragma unroll
  for (int k = 0; k < kS; ++k) {
    const long long e = dc * N + l + k * L;
    A[k] = -expf(__ldg(p.A_log + e));
    h[k] = p.h0 != nullptr ? __ldg(p.h0 + b * D * N + e) : 0.f;
  }

  // Staging items: (row, channel) = (i / G, i % G) with i = tid + k*kT, so
  // a warp reads along d; Bc/Cc items (row, c) = (j / 2N, j % 2N).
  const int ig = tid % G;
  const long long id = d0 + ig < D ? d0 + ig : D - 1;
  const bool ivalid = d0 + ig < D;
  const float bias = E::rnd(__ldg(p.dt_bias + id));
  const float dskip = E::rnd(__ldg(p.Dskip + id));
  const T* xb = xin + b * p.sx.b + id * p.sx.d;
  const T* db = dtp + b * p.sdt.b + id * p.sdt.d;
  const T* zb = z + b * p.sz.b + id * p.sz.d;
  const T* bcb = proj + b * p.sp.b + p.r * p.sp.d;

  // Raw values of the next tile, loaded while the current one runs: one a
  // value (rx, rd, rz, rbc), or 16-byte vectors (rv) and Bc/Cc in flight
  // to s_raw. A job of the 16-byte path is vector v of array kind (0 dt,
  // 1 z, 2 xin): along d, (row, d) = (v / (G/V), v % (G/V) * V); xin along
  // t when p.x_t, (d, row) = (v / (R/V), v % (R/V) * V).
  float rx[kVec ? 1 : kItems], rd[kVec ? 1 : kItems];
  float rz[kVec ? 1 : kItems], rbc[kVec ? 1 : kBC];
  uint4 rv[kVec ? Vc::kJobs : 1];
  auto load_tile = [&](long long t0, int which) {
    if constexpr (kVec) {
#pragma unroll
      for (int k = 0; k < Vc::kCopies; ++k) {
        const int j = tid + k * kT;
        if (j < R * Vc::kCPR) {
          const long long t = t0 + j / Vc::kCPR;
          cp_async16(&s_raw[which][j],
                     bcb + (t < S ? t : 0) * p.sp.t + (j % Vc::kCPR) * V,
                     t < S);
        }
      }
      cp_async_commit();
#pragma unroll
      for (int k = 0; k < Vc::kJobs; ++k) {
        const int job = tid + k * kT;
        rv[k] = make_uint4(0u, 0u, 0u, 0u);
        int kind = job / kNV;
        if (job >= (Vc::kXin + 1) * kNV || (kind >= 2 && kind != Vc::kXin))
          continue;
        if (kind == Vc::kXin) kind = 2;
        const int v = job % kNV;
        if (kind < 2 || !p.x_t) {
          const long long t = t0 + v / (G / V);
          const long long d = d0 + (v % (G / V)) * V;
          if (t < S && d < D) {
            const T* q = kind == 0   ? dtp + b * p.sdt.b + t * p.sdt.t
                         : kind == 1 ? z + b * p.sz.b + t * p.sz.t
                                     : xin + b * p.sx.b + t * p.sx.t;
            rv[k] = __ldg(reinterpret_cast<const uint4*>(q + d));
          }
        } else {
          const long long d = d0 + v / (R / V);
          const long long t = t0 + (v % (R / V)) * V;
          if (d < D && t < S)  // S is a multiple of V on this path
            rv[k] = __ldg(reinterpret_cast<const uint4*>(
                xin + b * p.sx.b + d * p.sx.d + t));
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const long long t = t0 + (tid + k * kT) / G;
        const bool in = t < S;
        rx[k] = in ? E::load(xb + t * p.sx.t) : 0.f;
        rd[k] = in ? E::load(db + t * p.sdt.t) : 0.f;
        rz[k] = in ? E::load(zb + t * p.sz.t) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kBC; ++k) {
        const int j = tid + k * kT;
        const long long t = t0 + j / (2 * N);
        rbc[k] = j < 2 * N * R && t < S
                     ? E::load(bcb + t * p.sp.t + (j % (2 * N)) * p.sp.d)
                     : 0.f;
      }
    }
  };
  // Bc at .x, Cc at .y of state's slot.
  auto put_bc = [&](int j, float v) {
    const int row = j / (2 * N), c = j % (2 * N), state = c % N;
    float* q = reinterpret_cast<float*>(&s_bc[row][state % L][state / L]);
    q[c < N ? 0 : 1] = v;
  };

  if constexpr (kVec) {
    if (tid < G) s_bias[tid] = E::rnd(__ldg(p.dt_bias + (d0 + tid < D ? d0 + tid : D - 1)));
  }
  load_tile(0, 0);
  if constexpr (kVec) {
    cp_async_wait_all();
    __syncthreads();
  }
  int buf = 0;
  for (long long t0 = 0; t0 < S; t0 += R, buf ^= 1) {
    const int rows = S - t0 < R ? static_cast<int>(S - t0) : R;
    // (1) stage: dt = softplus(...) and silu(z) once a (t, d), not a lane.
    if constexpr (kVec) {
#pragma unroll
      for (int k = 0; k < Vc::kJobs; ++k) {
        const int job = tid + k * kT;
        int kind = job / kNV;
        if (job >= (Vc::kXin + 1) * kNV || (kind >= 2 && kind != Vc::kXin))
          continue;
        if (kind == Vc::kXin) kind = 2;
        const int v = job % kNV;
        if (kind < 2 || !p.x_t) {
          const int row = v / (G / V), dd = (v % (G / V)) * V;
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float u = unpack<T>(rv[k], e);
            float* q = reinterpret_cast<float*>(&s_dx[buf][row][dd + e]);
            if (kind == 0) {
              q[0] = E::rnd(softplus_f(E::rnd(__fadd_rn(u, s_bias[dd + e]))));
            } else if (kind == 1) {
              s_sz[buf][row][dd + e] = E::rnd(silu_f(u));
            } else {
              q[1] = u;
            }
          }
        } else {
          const int dl = v / (R / V), tt = (v % (R / V)) * V;
#pragma unroll
          for (int e = 0; e < V; ++e)
            reinterpret_cast<float*>(&s_dx[buf][tt + e][dl])[1] =
                unpack<T>(rv[k], e);
        }
      }
      const T* raw = reinterpret_cast<const T*>(s_raw[buf]);
#pragma unroll
      for (int k = 0; k < kBC; ++k) {
        const int j = tid + k * kT;
        if (j < 2 * N * R) put_bc(j, to_f32(raw[j]));
      }
    } else {
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int row = (tid + k * kT) / G;
        const float sv = E::rnd(__fadd_rn(rd[k], bias));
        s_dx[buf][row][ig] = make_float2(E::rnd(softplus_f(sv)), rx[k]);
        s_sz[buf][row][ig] = E::rnd(silu_f(rz[k]));
      }
#pragma unroll
      for (int k = 0; k < kBC; ++k) {
        const int j = tid + k * kT;
        if (j < 2 * N * R) put_bc(j, rbc[k]);
      }
    }
    __syncthreads();
    if (t0 + R < S) load_tile(t0 + R, buf ^ 1);
    // (2) the recurrence, L rows at a time; rows is the same for every
    // thread of the block, so every lane takes part in each reduce_rows.
    auto step = [&](int row) {
      const float2 dx = s_dx[buf][row][g];
      float q = 0.f;
#pragma unroll
      for (int k = 0; k < kS; ++k) {
        const float2 bc = s_bc[row][l][k];
        const float abar = expf(__fmul_rn(dx.x, A[k]));
        h[k] = fmaf(abar, h[k], __fmul_rn(__fmul_rn(dx.x, bc.x), dx.y));
        q = k == 0 ? __fmul_rn(h[k], bc.y) : q + __fmul_rn(h[k], bc.y);
      }
      return q;
    };
#pragma unroll
    for (int r0 = 0; r0 < R; r0 += L) {
      if (r0 >= rows) break;
      float q[L];
      if (r0 + L <= rows) {  // every tile but the last: no checks a row
#pragma unroll
        for (int u = 0; u < L; ++u) q[u] = step(r0 + u);
      } else {
#pragma unroll
        for (int u = 0; u < L; ++u) q[u] = r0 + u < rows ? step(r0 + u) : 0.f;
      }
      reduce_rows<L>(q, l);
      if (r0 + l < rows) s_y[r0 + l][g] = q[0];
    }
    if constexpr (kVec) cp_async_wait_all();  // the next tile's Bc/Cc
    __syncthreads();
    // (3) epilogue, along d.
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int row = (tid + k * kT) / G;
      if (row < rows && ivalid) {
        const float x = s_dx[buf][row][ig].y;
        const float skip = E::rnd(__fmul_rn(dskip, x));
        const float yv = E::rnd(__fadd_rn(E::rnd(s_y[row][ig]), skip));
        E::store(y + (b * S + t0 + row) * D + d0 + ig,
                 __fmul_rn(yv, s_sz[buf][row][ig]));
      }
    }
  }
  if (p.hS != nullptr && active) {
#pragma unroll
    for (int k = 0; k < kS; ++k) p.hS[(b * D + d0 + g) * N + l + k * L] = h[k];
  }
}

// S = 1, a decode step: a group of N lanes a channel as in scan_kernel,
// every lane computing the channel's dt and silu(z) itself (one step has
// no tile to share them over, and a copy a lane costs no latency), the
// N-sum by the butterfly, lane 0 writing y. A small kernel with one short
// chain: the decode step of every Mamba layer runs it.
template <int N, typename T>
__global__ void __launch_bounds__(kThreads)
fused_step_kernel(const FusedArgs p) {
  using E = Elt<T>;
  constexpr int kGroups = kThreads / N;
  const int n = threadIdx.x % N;
  const long long channels = p.B * p.D;
  const long long ch =
      static_cast<long long>(blockIdx.x) * kGroups + threadIdx.x / N;
  const bool active = ch < channels;
  const long long c = active ? ch : channels - 1;  // c = b*D + d
  const long long b = c / p.D, d = c % p.D;
  const float x = E::load(static_cast<const T*>(p.xin) + b * p.sx.b +
                          d * p.sx.d);
  const float dtp = E::load(static_cast<const T*>(p.dtp) + b * p.sdt.b +
                            d * p.sdt.d);
  const float zv = E::load(static_cast<const T*>(p.z) + b * p.sz.b +
                           d * p.sz.d);
  const T* bc = static_cast<const T*>(p.proj) + b * p.sp.b + p.r * p.sp.d;
  const float Bn = E::load(bc + n * p.sp.d);
  const float Cn = E::load(bc + (N + n) * p.sp.d);
  const float A = -expf(__ldg(p.A_log + d * N + n));
  float h = p.h0 != nullptr ? __ldg(p.h0 + c * N + n) : 0.f;
  const float s = E::rnd(__fadd_rn(dtp, E::rnd(__ldg(p.dt_bias + d))));
  const float dt = E::rnd(softplus_f(s));
  h = fmaf(expf(__fmul_rn(dt, A)), h, __fmul_rn(__fmul_rn(dt, Bn), x));
  const float y32 = group_sum<N>(__fmul_rn(h, Cn));
  if (active && n == 0) {
    const float skip = E::rnd(__fmul_rn(E::rnd(__ldg(p.Dskip + d)), x));
    const float yv = E::rnd(__fadd_rn(E::rnd(y32), skip));
    E::store(static_cast<T*>(p.y) + c, __fmul_rn(yv, E::rnd(silu_f(zv))));
  }
  if (p.hS != nullptr && active) p.hS[c * N + n] = h;
}

// Whether fused_kernel's 16-byte path can read these views: dt_pre and z
// along d, xin along d (0) or along t (1, in whole runs: S a multiple of
// V), and Bc/Cc rows, each in runs of V values that start 16-byte aligned;
// -1 if not.
template <typename T>
int vec_layout(const FusedArgs& a) {
  constexpr long long V = 16 / static_cast<long long>(sizeof(T));
  auto al = [](const void* q, long long off) {
    return ((reinterpret_cast<uintptr_t>(q) + off * sizeof(T)) & 15u) == 0;
  };
  auto along_d = [&](const void* q, const View3& s) {
    return al(q, 0) && s.d == 1 && s.t % V == 0 && s.b % V == 0;
  };
  if (a.D % V != 0 || !along_d(a.dtp, a.sdt) || !along_d(a.z, a.sz) ||
      !(al(a.proj, a.r) && a.sp.d == 1 && a.sp.t % V == 0 && a.sp.b % V == 0))
    return -1;
  if (along_d(a.xin, a.sx)) return 0;
  if (al(a.xin, 0) && a.sx.t == 1 && a.sx.d % V == 0 && a.sx.b % V == 0 &&
      a.S % V == 0)
    return 1;
  return -1;
}

template <int N, typename T>
cudaError_t launch_fused(const FusedArgs& a, cudaStream_t st) {
  if (a.S == 1) {
    constexpr long long kGroups = kThreads / N;
    const long long blocks = (a.B * a.D + kGroups - 1) / kGroups;
    if (blocks > INT_MAX) return cudaErrorInvalidValue;
    fused_step_kernel<N, T>
        <<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(a);
    return cudaGetLastError();
  }
  constexpr int G = FusedShape<N>::kG;
  const long long tiles = (a.D + G - 1) / G;
  if (tiles > INT_MAX || a.B > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(a.B));
  if constexpr (FusedVec<N, T>::kOk) {
    const int x_t = vec_layout<T>(a);
    if (x_t >= 0) {
      FusedArgs v = a;
      v.x_t = x_t;
      fused_kernel<N, T, true><<<grid, FusedShape<N>::kThreads, 0, st>>>(v);
      return cudaGetLastError();
    }
  }
  fused_kernel<N, T, false><<<grid, FusedShape<N>::kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fused_n(const FusedArgs& a, int N, cudaStream_t st) {
  switch (N) {
    case 1: return launch_fused<1, T>(a, st);
    case 2: return launch_fused<2, T>(a, st);
    case 4: return launch_fused<4, T>(a, st);
    case 8: return launch_fused<8, T>(a, st);
    case 16: return launch_fused<16, T>(a, st);
    case 32: return launch_fused<32, T>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

// -- backward -----------------------------------------------------------------
// One thread a state element (b, d, n), as scan_kernel; a block is one batch
// row b and G = 256/N channels, so that the sums over d of dC (and dBc) start
// as fixed-order block partials. A thread first runs the recurrence forward,
// then walks S backwards in segments of Q steps: at the end of a segment the
// block sums its warps' partials of the segment's steps and writes one row a
// step to `part` (B, S, nblk, K, N); ordered_sum_kernel then adds the nblk
// blocks' rows in block order. No atomics: every sum has a fixed order.
constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;

template <int N>
struct BwdShape {
  static constexpr int kG = kBwdThreads / N;      // channels a block
  static constexpr int kQ = N == 32 ? 16 : 32;    // steps a segment
};

// Sum over the channels of a warp: lanes n, n + N, n + 2N, ... all end with
// the warp's sum for state n, added in the same order on every run.
template <int N>
__device__ __forceinline__ float warp_channel_sum(float v) {
#pragma unroll
  for (int o = N; o < 32; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The block's sums of a segment's `len` steps: s[u][w][k][n] holds warp w's
// partial of step u; row (row0 + u) of part gets their sum in warp order.
template <int N, int K, int Q>
__device__ __forceinline__ void flush_partials(const float (&s)[Q][kBwdWarps][K][N],
                                               float* part, long long row0,
                                               int len, int nblk) {
  for (int i = threadIdx.x; i < len * K * N; i += kBwdThreads) {
    const int u = i / (K * N), kn = i % (K * N);
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) v += s[u][w][kn / N][kn % N];
    part[((row0 + u) * nblk + blockIdx.x) * (K * N) + kn] = v;
  }
}

// scan_bwd_kernel — the gradient of scan_kernel (the literal entry). No TPU
//   kernel: the reference differentiates _chunked_scan (src/repro/models/
//   ssm.py) with XLA. From gy (B,S,D) and the forward's inputs:
//     g_t    = gy_t[d] C_t[n] + Abar_{t+1} g_{t+1}       (g_S = 0)
//     dBx_t  = g_t,  dAbar_t = g_t h_{t-1},  dh0 = Abar_0 g_0
//     dC_t[n] = sum_d gy_t[d] h_t[d,n]
//   The forward pass writes h_t into dAbar's buffer; the backward pass reads
//   h_{t-1} from there before it overwrites slot t with dAbar_t, so no other
//   (B,S,D,N) buffer is needed. Shadow lanes (d >= D) read no h and write
//   nothing.
//
//   Bound: bytes. Abar, Bx read and dAbar, dBx written once are 16 bytes an
//   element: 1.07 GB -> 0.32 ms at B=2, S=2048, D=8192, N=16 (gy, C, dC and
//   h0 are 1/N of that or less). This simple kernel moves about 28 bytes an
//   element (Abar twice, h written and read back).
template <int N>
__global__ void __launch_bounds__(kBwdThreads)
scan_bwd_kernel(const float* __restrict__ A, const float* __restrict__ Bx,
                const float* __restrict__ C, const float* __restrict__ h0,
                const float* __restrict__ gy, float* dA, float* __restrict__ dBx,
                float* __restrict__ part, float* __restrict__ dh0, long long S,
                long long D, int nblk) {
  constexpr int G = BwdShape<N>::kG, Q = BwdShape<N>::kQ;
  __shared__ float s_part[Q][kBwdWarps][1][N];
  const int n = threadIdx.x % N, lane = threadIdx.x % 32,
            warp = threadIdx.x / 32;
  const long long b = blockIdx.y;
  const long long d = static_cast<long long>(blockIdx.x) * G + threadIdx.x / N;
  const bool active = d < D;
  const long long dc = active ? d : D - 1;  // shadow the last channel
  const long long step = D * N;
  const long long base = (b * S * D + dc) * N + n;  // (b, 0, dc, n)
  const float* cp = C + b * S * N + n;
  const float* gp = gy + b * S * D + dc;
  const float hinit =
      h0 != nullptr && active ? h0[(b * D + dc) * N + n] : 0.f;

  float h = hinit;
  for (long long t = 0; t < S; ++t) {
    h = fmaf(__ldg(A + base + t * step), h, __ldg(Bx + base + t * step));
    if (active) dA[base + t * step] = h;
  }
  float ht = h, g = 0.f, anext = 0.f;  // h_t, g_{t+1}, Abar_{t+1}
  for (long long t0 = (S - 1) / Q * Q; t0 >= 0; t0 -= Q) {
    const int len = S - t0 < Q ? static_cast<int>(S - t0) : Q;
    for (int u = len - 1; u >= 0; --u) {
      const long long t = t0 + u, e = base + t * step;
      const float gyt = __ldg(gp + t * D);
      g = fmaf(anext, g, gyt * __ldg(cp + t * N));
      const float hp = !active ? 0.f : t > 0 ? dA[e - step] : hinit;
      const float pc = warp_channel_sum<N>(active ? gyt * ht : 0.f);
      if (lane < N) s_part[u][warp][0][lane] = pc;
      if (active) {
        dBx[e] = g;
        dA[e] = g * hp;
      }
      anext = __ldg(A + e);
      ht = hp;
    }
    __syncthreads();
    flush_partials<N, 1, Q>(s_part, part, b * S + t0, len, nblk);
    __syncthreads();
  }
  if (dh0 != nullptr && active) dh0[(b * D + dc) * N + n] = anext * g;
}

// fused_bwd_kernel — the gradient of the fused entry's discretization and
//   scan; the skip, gate and softplus derivatives are torch ops around it
//   (kernels/mamba_scan.py). No TPU kernel: the reference differentiates
//   _fused_chunk_scan (src/repro/models/ssm.py) with XLA. From fp32 dt, x
//   (B,S,D), Bc|Cc (B,S,2N), A = -exp(A_log) (D,N), h0 and dy = dL/dy32
//   (B,S,D), with Abar = exp(dt A) and Bx = dt Bc x recomputed here as
//   fused_kernel computes them:
//     g_t = dy_t Cc_t + Abar_{t+1} g_{t+1}
//     ddt_t[d]  = sum_n g_t (h_{t-1} Abar_t A + Bc_t x_t),  dx_t[d] = sum_n g_t dt_t Bc_t
//     dBc_t[n]  = sum_d g_t dt_t x_t,   dCc_t[n] = sum_d dy_t h_t
//     dA[d,n]   = sum_{b,t} g_t h_{t-1} Abar_t dt_t,  dh0 = Abar_0 g_0
//   and y32 (B,S,D), the scan's readout, which the gate's derivative needs.
//   No (B,S,D,N) tensor is stored: the forward pass keeps the state at the
//   start of every Q-step segment in hseg (B, ceil(S/Q), D, N); the
//   backward pass recomputes a segment's states from there into registers
//   (hp, unrolled) and walks it backwards. The sums over n are butterflies
//   inside a channel's lanes; over d, block partials (flush_partials); dA
//   sums a segment at a time, then over segments, then over B
//   (ordered_sum_kernel).
//
//   Bound: bytes at B=2, S=2048, D=8192, N=16: dt, x, dy, y32, ddt and dx
//   (B,S,D) fp32 once each, 0.81 GB -> 0.24 ms; special-function units: an
//   ex2 for Abar a (b,t,d,n) in each pass, 3 passes, 0.81e9 -> 0.19 ms.
template <int N>
struct FusedBwdArgs {
  const float* dt;
  const float* x;
  const float* bc;
  const float* A;
  const float* h0;
  const float* dy;
  float* y32;
  float* hseg;
  float* ddt;
  float* dx;
  float* part;
  float* dApart;
  float* dh0;
  long long S, D;
  int nblk;
};

template <int N>
__global__ void __launch_bounds__(kBwdThreads)
fused_bwd_kernel(const FusedBwdArgs<N> p) {
  constexpr int G = BwdShape<N>::kG, Q = BwdShape<N>::kQ;
  __shared__ float s_part[Q][kBwdWarps][2][N];
  const int n = threadIdx.x % N, lane = threadIdx.x % 32,
            warp = threadIdx.x / 32;
  const long long b = blockIdx.y, S = p.S, D = p.D;
  const long long d = static_cast<long long>(blockIdx.x) * G + threadIdx.x / N;
  const bool active = d < D;
  const long long dc = active ? d : D - 1;  // shadow the last channel
  const float Av = __ldg(p.A + dc * N + n);
  const long long row = b * S * D + dc;     // (b, 0, dc) of a (B,S,D) array
  const float* bcp = p.bc + b * S * 2 * N + n;
  const long long nseg = (S + Q - 1) / Q;
  float* hs = p.hseg + (b * nseg * D + dc) * N + n;  // segment k at k*D*N
  const float hinit =
      p.h0 != nullptr && active ? __ldg(p.h0 + (b * D + dc) * N + n) : 0.f;

  float h = hinit;
  for (long long t = 0; t < S; ++t) {
    if (t % Q == 0 && active) hs[t / Q * D * N] = h;
    const float dt = __ldg(p.dt + row + t * D), x = __ldg(p.x + row + t * D);
    const float abar = expf(__fmul_rn(dt, Av));
    h = fmaf(abar, h, __fmul_rn(__fmul_rn(dt, __ldg(bcp + t * 2 * N)), x));
    const float y = group_sum<N>(__fmul_rn(h, __ldg(bcp + t * 2 * N + N)));
    if (active && n == 0) p.y32[row + t * D] = y;
  }
  float g = 0.f, anext = 0.f, dA = 0.f;  // g_{t+1}, Abar_{t+1}
  for (long long k = nseg - 1; k >= 0; --k) {
    const long long t0 = k * Q;
    const int len = S - t0 < Q ? static_cast<int>(S - t0) : Q;
    float hp[Q + 1];  // hp[u] = h_{t0+u-1}
    hp[0] = active ? hs[k * D * N] : 0.f;
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      if (u < len) {
        const long long t = t0 + u;
        const float dt = __ldg(p.dt + row + t * D);
        const float abar = expf(__fmul_rn(dt, Av));
        hp[u + 1] = fmaf(abar, hp[u],
                         __fmul_rn(__fmul_rn(dt, __ldg(bcp + t * 2 * N)),
                                   __ldg(p.x + row + t * D)));
      }
    }
    float dA_seg = 0.f;
#pragma unroll
    for (int u = Q - 1; u >= 0; --u) {
      if (u < len) {
        const long long t = t0 + u;
        const float dt = __ldg(p.dt + row + t * D), x = __ldg(p.x + row + t * D);
        const float Bn = __ldg(bcp + t * 2 * N), Cn = __ldg(bcp + t * 2 * N + N);
        const float dy = __ldg(p.dy + row + t * D);
        const float abar = expf(__fmul_rn(dt, Av));
        g = fmaf(anext, g, dy * Cn);
        const float dlin = g * hp[u] * abar;  // dL/d(dt A)
        dA_seg += dlin * dt;
        const float pdt = group_sum<N>(dlin * Av + g * Bn * x);
        const float px = group_sum<N>(g * dt * Bn);
        if (active && n == 0) {
          p.ddt[row + t * D] = pdt;
          p.dx[row + t * D] = px;
        }
        const float pb = warp_channel_sum<N>(active ? g * dt * x : 0.f);
        const float pc = warp_channel_sum<N>(active ? dy * hp[u + 1] : 0.f);
        if (lane < N) {
          s_part[u][warp][0][lane] = pb;
          s_part[u][warp][1][lane] = pc;
        }
        anext = abar;
      }
    }
    dA += dA_seg;
    __syncthreads();
    flush_partials<N, 2, Q>(s_part, p.part, b * S + t0, len, p.nblk);
    __syncthreads();
  }
  if (active) {
    p.dApart[(b * D + dc) * N + n] = dA;
    if (p.dh0 != nullptr) p.dh0[(b * D + dc) * N + n] = anext * g;
  }
}

template <int N>
cudaError_t launch_bwd(const float* A, const float* Bx, const float* C,
                       const float* h0, const float* gy, float* dA, float* dBx,
                       float* dC, float* dh0, float* part, long long B,
                       long long S, long long D, cudaStream_t st) {
  constexpr long long G = BwdShape<N>::kG;
  const long long nblk = (D + G - 1) / G;
  if (nblk > INT_MAX || B > 65535) return cudaErrorInvalidValue;
  scan_bwd_kernel<N><<<dim3(static_cast<unsigned>(nblk),
                            static_cast<unsigned>(B)), kBwdThreads, 0, st>>>(
      A, Bx, C, h0, gy, dA, dBx, part, dh0, S, D, static_cast<int>(nblk));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return ckio::ordered_sum(part, dC, B * S, nblk, N, st);
}

template <int N>
cudaError_t launch_fused_bwd(FusedBwdArgs<N> a, long long B, float* dBC,
                             float* dA, cudaStream_t st) {
  constexpr long long G = BwdShape<N>::kG;
  const long long nblk = (a.D + G - 1) / G;
  if (nblk > INT_MAX || B > 65535) return cudaErrorInvalidValue;
  a.nblk = static_cast<int>(nblk);
  fused_bwd_kernel<N><<<dim3(static_cast<unsigned>(nblk),
                             static_cast<unsigned>(B)), kBwdThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = ckio::ordered_sum(a.part, dBC, B * a.S, nblk, 2 * N, st);
  if (err != cudaSuccess) return err;
  return ckio::ordered_sum(a.dApart, dA, 1, B, a.D * N, st);
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

// xin, dt_pre, z: (B,S,D); proj: (B,S,r+2N); each of the four with its
// (b, t, d) element strides in strides[0..11], in that order, in the
// compute dtype (bf16 when bf16 != 0, else fp32). dt_bias, Dskip: (D);
// A_log: (D,N); h0: (B,D,N) or null; all fp32, contiguous. y: (B,S,D)
// contiguous in the compute dtype; hS: (B,D,N) fp32 or null.
extern "C" int ckio_mamba_scan_fused(
    const void* xin, const void* dt_pre, const void* z, const void* proj,
    const float* dt_bias, const float* A_log, const float* Dskip,
    const float* h0, void* y, float* hS, long long B, long long S,
    long long D, int N, long long r, int bf16, const long long* strides,
    void* stream) {
  if (B < 1 || S < 0 || D < 1 || r < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  FusedArgs a;
  a.xin = xin; a.dtp = dt_pre; a.z = z; a.proj = proj;
  a.dt_bias = dt_bias; a.A_log = A_log; a.Dskip = Dskip; a.h0 = h0;
  a.y = y; a.hS = hS; a.B = B; a.S = S; a.D = D; a.r = r; a.x_t = 0;
  View3* views[4] = {&a.sx, &a.sdt, &a.sz, &a.sp};
  for (int i = 0; i < 4; ++i)
    *views[i] = View3{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16 ? launch_fused_n<__nv_bfloat16>(a, N, st)
                               : launch_fused_n<float>(a, N, st);
  return static_cast<int>(err);
}

// The literal scan's gradient. gy: (B,S,D); A, Bx: (B,S,D,N); C: (B,S,N);
// h0: (B,D,N) or null; all fp32, contiguous. Writes dA, dBx (B,S,D,N), dC
// (B,S,N) and, when dh0 is not null, dh0 (B,D,N); part is scratch of
// B*S*ceil(D/(256/N))*N floats.
extern "C" int ckio_mamba_scan_backward(const float* A, const float* Bx,
                                        const float* C, const float* h0,
                                        const float* gy, float* dA, float* dBx,
                                        float* dC, float* dh0, float* part,
                                        long long B, long long S, long long D,
                                        int N, void* stream) {
  if (B < 1 || S < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (N) {
#define CKIO_BWD(n)                                                          \
  case n:                                                                    \
    err = launch_bwd<n>(A, Bx, C, h0, gy, dA, dBx, dC, dh0, part, B, S, D, st); \
    break;
    CKIO_BWD(1) CKIO_BWD(2) CKIO_BWD(4) CKIO_BWD(8) CKIO_BWD(16) CKIO_BWD(32)
#undef CKIO_BWD
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The fused entry's discretization and scan, differentiated. dt, x, dy:
// (B,S,D); bc: (B,S,2N) (Bc then Cc); A: (D,N) = -exp(A_log); h0: (B,D,N)
// or null; all fp32, contiguous. Writes y32, ddt, dx (B,S,D), dBC (B,S,2N),
// dA (D,N) and, when dh0 is not null, dh0 (B,D,N). Scratch: hseg
// B*ceil(S/Q)*D*N floats (Q = 32, 16 at N = 32), part
// B*S*ceil(D/(256/N))*2N floats, dApart B*D*N floats.
extern "C" int ckio_mamba_scan_fused_backward(
    const float* dt, const float* x, const float* bc, const float* A,
    const float* h0, const float* dy, float* y32, float* hseg, float* ddt,
    float* dx, float* part, float* dBC, float* dApart, float* dA, float* dh0,
    long long B, long long S, long long D, int N, void* stream) {
  if (B < 1 || S < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (N) {
#define CKIO_FBWD(n)                                                         \
  case n: {                                                                  \
    FusedBwdArgs<n> a{dt, x, bc, A, h0, dy, y32, hseg, ddt, dx, part,        \
                      dApart, dh0, S, D, 0};                                 \
    err = launch_fused_bwd<n>(a, B, dBC, dA, st);                            \
    break;                                                                   \
  }
    CKIO_FBWD(1) CKIO_FBWD(2) CKIO_FBWD(4) CKIO_FBWD(8) CKIO_FBWD(16)
    CKIO_FBWD(32)
#undef CKIO_FBWD
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
