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
//   group are reduced together (lane_reduce: L - 1 shuffles for L rows,
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
using ckio::sigmoid_f;
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

// Sums p[0..R) over the lanes that differ from this one in the lane bits
// kHi, kHi/2, ..., kLo, the highest first, in a fixed order. While a lane
// holds more than one row a stage hands half of them to its partner
// (the exchange); once one row is left a stage adds the partner's (a
// butterfly: both lanes get the same bits). Ends with rows [row0, row0 +
// max(R >> stages, 1)) in p[0..). Over a group's L lanes with L rows (kHi
// = L/2, kLo = 1): L - 1 shuffles where a butterfly a row takes L log2 L,
// and lane l ends with row l's sum in p[0].
template <int R, int kCur, int kM, int kLo>
__device__ __forceinline__ void lane_reduce_step(float (&p)[R], int lane,
                                                 int& row0) {
  if constexpr (kM >= kLo && kM > 0) {
    if constexpr (kCur > 1) {
      constexpr int kHalf = kCur / 2;
      const bool upper = (lane & kM) != 0;
#pragma unroll
      for (int k = 0; k < kHalf; ++k) {
        const float send = upper ? p[k] : p[k + kHalf];
        const float keep = upper ? p[k + kHalf] : p[k];
        p[k] = keep + __shfl_xor_sync(kFull, send, kM);
      }
      if (upper) row0 += kHalf;
      lane_reduce_step<R, kHalf, kM / 2, kLo>(p, lane, row0);
    } else {
      p[0] += __shfl_xor_sync(kFull, p[0], kM);
      lane_reduce_step<R, 1, kM / 2, kLo>(p, lane, row0);
    }
  }
}

template <int R, int kHi, int kLo>
__device__ __forceinline__ int lane_reduce(float (&p)[R], int lane) {
  int row0 = 0;
  lane_reduce_step<R, R, kHi, kLo>(p, lane, row0);
  return row0;
}

// The rows a lane holds after lane_reduce<R, kHi, kLo>, and the lane bits
// of its butterfly stages (a row's owner has them clear).
__host__ __device__ constexpr int lane_rows(int R, int kHi, int kLo) {
  for (int m = kHi; m >= kLo && m > 0; m >>= 1) R = R > 1 ? R / 2 : 1;
  return R;
}
__host__ __device__ constexpr int butterfly_bits(int R, int kHi,
                                                  int kLo) {
  int bits = 0;
  for (int m = kHi; m >= kLo && m > 0; m >>= 1) {
    if (R == 1) bits |= m;
    R = R > 1 ? R / 2 : 1;
  }
  return bits;
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
    // thread of the block, so every lane takes part in each lane_reduce.
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
      lane_reduce<L, L / 2, 1>(q, l);
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
// The fused entry's gradient: the kernels below, launched in this order by
// launch_fused_bwd.
//   No TPU kernel: the reference differentiates _fused_chunk_scan
//   (src/repro/models/ssm.py) and the skip and gate around it with XLA. From
//   gy and the forward's inputs (xin, dt_pre, z, proj in the compute dtype T
//   through their strides, fp32 dt_bias, A_log, Dskip, h0), with the
//   forward's rounding (fused_kernel) for dt = rnd(softplus(s)), s =
//   rnd(dt_pre + rnd(dt_bias)), and dy = rnd(gy rnd(silu(z))):
//     g_t = dy_t Cc_t + Abar_{t+1} g_{t+1},     dh0 = Abar_0 g_0
//     ddt_t[d] = sum_n g_t h_{t-1} Abar_t A + x_t sum_n g_t Bc_t
//     dx_t[d]  = dt_t sum_n g_t Bc_t,            y32_t[d] = sum_n h_t Cc_t
//     dBc_t[n] = sum_d g_t dt_t x_t,             dCc_t[n] = sum_d dy_t h_t
//     dA[d,n]  = sum_{b,t} g_t h_{t-1} Abar_t dt_t
//   and the epilogue, rounded where ref.mamba_scan_fused_bwd_ref rounds to
//   T: ypre = rnd(rnd(y32) + rnd(rnd(Dskip) x)), dz = rnd(rnd(gy ypre) *
//   rnd(sig rnd(1 + rnd(z rnd(1 - sig))))) with sig = rnd(sigmoid(z)),
//   dxin = rnd(rnd(dy rnd(Dskip)) + rnd(dx)), ds = rnd(rnd(ddt) * (s > 20 ?
//   1 : rnd(sigmoid(s)))) (= ddt_pre), dDskip = sum rnd(dy x), ddt_bias =
//   sum ds, dproj = (0 | rnd(dBc) | rnd(dCc)).
//
//   Bound at B=2, S=2048, D=8192, N=16 in bf16: special-function results,
//   an ex2 for Abar a (b,t,d,n) and four a (b,t,d), 6.71e8 -> 0.160 ms;
//   bytes (gy, xin, dt_pre, z read, dxin, ddt_pre, dz written, proj and
//   dproj) 0.476 GB -> 0.142 ms.
//
//   Design: the sequence is cut into chunks of kT steps and a block owns
//   one chunk of kG channels of one batch row; a channel's N states are kL
//   lanes of kS states each, so most sums over n are adds inside a thread.
//   (1) fused_bwd_sum_kernel: each chunk from zero, in both directions at
//       once -- the local end state, and the local adjoint sum_u P_u dy_u
//       Cc_u (P_u the product of Abar over the chunk's first u+1 steps, =
//       Abar_{t0} g_{t0} with g = 0 past the chunk) -- and its sum of dt,
//       whose decay exp(A sum dt) is the chunk's product of Abar. It
//       computes dt, dy and the epilogue's factors of dz and ddt_pre once
//       a (t, d) (softplus, silu, two sigmoids: most of the function's
//       special-function and division work) and leaves them, rounded to T,
//       in two planes of value pairs for (3).
//   (2) fused_bwd_carry_kernel: a thread a state and direction walks the
//       chunks in order, forward from h0 or backward from 0, and leaves
//       each chunk's carry-in state or adjoint carry (Abar g of its
//       successor's first step) in place of its summaries.
//   (3) fused_bwd_kernel: the chunk again from its carries. The chunk's
//       operands are staged once in shared memory (dt, dy from the plane,
//       once a (t, d), not once a lane); a forward pass keeps the state at
//       each kQ-step sub-segment's start in shared memory; then the
//       sub-segments from the last to the first recompute their states
//       into registers and run the adjoint back over them. The sums over n
//       finish over a channel's kL lanes a sub-segment at a time
//       (lane_reduce, kL - 1 shuffles for kL rows); the sums over d over
//       the warp's channels by lane_reduce, then over the block's warps in
//       warp order, into part (B, S, nblk, 2N): a block's kG channels
//       summed before they leave it. The epilogue runs along d from shared
//       memory and writes dxin, ddt_pre and dz once.
//   (4) proj_grad_kernel and ordered_sum_kernel: dproj's rows from part in
//       block order, and dA, dDskip and ddt_bias over the (b, chunk)
//       partials in order.
//   No atomics: every sum has a fixed order, so two runs give the same
//   bits. No (B, S, D, N) tensor exists: the scratch is (B, S/kT, D, N)
//   twice, (B, S, D/kG, 2N), (B, S/kT, D, N) (the dA partials) and the two
//   (B, S, D) planes.
//   Abar is ex2.approx of dt * A log2(e) (2 ulp) here; the forward kernel
//   keeps torch's exp, whose bits the decode replay needs.
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

template <int N>
struct FusedBwdShape {
  static constexpr int kS = N < 4 ? N : 4;          // states a lane
  static constexpr int kL = N / kS;                 // lanes a channel
  static constexpr int kG = N == 32 ? 64 : 128;     // channels a block
  static constexpr int kThreads = kG * kL;          // 128 to 512
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kT = 64;                     // steps a chunk
  static constexpr int kQ = 8;                      // steps a sub-segment
  static constexpr int kEpi = kQ * kG / kThreads;   // epilogue items a thread
};

// A chunk's operands in fp32 (x padded by a column: it is staged along t
// when xin is channel-major). Zeros past S and past D: the identity step
// (Abar = 1, Bx = 0, no adjoint input), so no shadow adds to a sum.
template <int N>
struct FusedBwdStage {
  using Sh = FusedBwdShape<N>;
  float2 tdy[Sh::kT][Sh::kG];    // (dt, dy): one 8-byte load a step
  float x[Sh::kT][Sh::kG + 1];
  float bc[Sh::kT][2 * N];      // Bc | Cc; a lane's kS states 16-byte aligned
};

// A lane's kS states of a row of Bc or Cc, one 16-byte load at kS = 4.
template <int kS>
__device__ __forceinline__ void lds_states(const float* q, float (&v)[kS]) {
  if constexpr (kS == 4) {
    const float4 w = *reinterpret_cast<const float4*>(q);
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  } else {
#pragma unroll
    for (int k = 0; k < kS; ++k) v[k] = q[k];
  }
}

template <int N>
struct FusedBwdSmem : FusedBwdStage<N> {
  using Sh = FusedBwdShape<N>;
  float hb[Sh::kT / Sh::kQ][Sh::kS][Sh::kThreads];  // sub-segment starts
  // A sub-segment's sums for the epilogue, double-buffered so that one
  // barrier a sub-segment separates writers and readers.
  float ns[2][3][Sh::kQ][Sh::kG + 4];               // y32, ddt's two sums
  float dsum[2][Sh::kQ][Sh::kWarps][2 * N];         // a warp's dBc | dCc
};

// Two values, each already rounded to T, in one word: 4 bytes in bf16 (the
// high halves of the two floats), 8 in fp32. The summary kernel leaves a
// chunk's (dt, dy) and (dsil, sgs) in two such planes for fused_bwd_kernel.
template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using W = float2;
  __device__ static W pack(float a, float b) { return make_float2(a, b); }
  __device__ static float2 unpack(W w) { return w; }
};
template <>
struct Pair<__nv_bfloat16> {
  using W = unsigned;
  __device__ static W pack(float a, float b) {
    return (__float_as_uint(a) >> 16) | (__float_as_uint(b) & 0xffff0000u);
  }
  __device__ static float2 unpack(W w) {
    return make_float2(__uint_as_float(w << 16),
                       __uint_as_float(w & 0xffff0000u));
  }
};

struct FusedBwdArgs {
  const void* gy;
  const void* xin;
  const void* dtp;
  const void* z;
  const void* proj;
  const float* dt_bias;
  const float* A_log;
  const float* Dskip;
  const float* h0;
  void* dxin;          // (B,S,D) contiguous, T
  void* ddt;           // dL/d dt_pre, (B,S,D) contiguous, T
  void* dz;            // (B,S,D) contiguous, T
  void* dproj;         // (B,S,r+2N) contiguous, T
  float* dh0;
  float* sums;         // (B,C,D,N) states, (B,C,D,N) adjoints, (B,C,D) sum dt
  float* part;         // (B,S,nblk,2N)
  float* dApart;       // (B*C,D,N)
  float* chan;         // (2,B*C,D): dDskip, ddt_bias
  void* tdy;           // (B,S,D) Pair<T>: dt, dy
  void* dsg;           // (B,S,D) Pair<T>: dsil, sgs (the epilogue's factors)
  long long B, S, D, r, C;
  View3 sgy, sx, sdt, sz, sp;
  int x_t;             // xin is channel-major: stage it along t
};

// A chunk's operands into shared memory. The summary kernel (kFirst)
// computes dt and dy once a (t, d) from dt_pre, z and gy, with the
// epilogue's factors dsil = rnd(sig rnd(1 + rnd(z rnd(1 - sig)))) (sig =
// rnd(sigmoid(z))) and sgs = (s > 20 ? 1 : rnd(sigmoid(s))), and leaves both
// pairs in the planes; fused_bwd_kernel reads (dt, dy) back from there.
template <int N, typename T, bool kFirst>
__device__ __forceinline__ void stage_chunk(const FusedBwdArgs& p,
                                            FusedBwdStage<N>& s, long long b,
                                            long long d0, long long t0,
                                            int rows) {
  using Sh = FusedBwdShape<N>;
  using E = Elt<T>;
  using W = typename Pair<T>::W;
  constexpr int G = Sh::kG, kT = Sh::kT, kTh = Sh::kThreads;
  const T* dtp = static_cast<const T*>(p.dtp) + b * p.sdt.b;
  const T* z = static_cast<const T*>(p.z) + b * p.sz.b;
  const T* gy = static_cast<const T*>(p.gy) + b * p.sgy.b;
  const T* xin = static_cast<const T*>(p.xin) + b * p.sx.b;
  const T* bc = static_cast<const T*>(p.proj) + b * p.sp.b + p.r * p.sp.d;
  W* tdy = static_cast<W*>(p.tdy) + b * p.S * p.D;
  W* dsg = static_cast<W*>(p.dsg) + b * p.S * p.D;
  const int tid = threadIdx.x;
#pragma unroll 4
  for (int i = tid; i < kT * G; i += kTh) {  // along d
    const int u = i / G, g = i % G;
    const long long t = t0 + u, d = d0 + g, o = t * p.D + d;
    float2 v = make_float2(0.f, 0.f);
    if (u < rows && d < p.D) {
      if constexpr (kFirst) {
        const float sv = E::rnd(__fadd_rn(
            E::load(dtp + t * p.sdt.t + d * p.sdt.d),
            E::rnd(__ldg(p.dt_bias + d))));
        const float zf = E::load(z + t * p.sz.t + d * p.sz.d);
        const float ez = 1.f + expf(-zf);  // silu_f's and sigmoid_f's
        const float sig = E::rnd(1.f / ez);
        v.x = E::rnd(softplus_f(sv));
        v.y = E::rnd(__fmul_rn(E::load(gy + t * p.sgy.t + d * p.sgy.d),
                               E::rnd(zf / ez)));
        const float zs = E::rnd(__fmul_rn(zf, E::rnd(__fsub_rn(1.f, sig))));
        const float dsil = E::rnd(__fmul_rn(sig, E::rnd(__fadd_rn(1.f, zs))));
        tdy[o] = Pair<T>::pack(v.x, v.y);
        dsg[o] = Pair<T>::pack(dsil, sv > 20.f ? 1.f : E::rnd(sigmoid_f(sv)));
      } else {
        v = Pair<T>::unpack(tdy[o]);
      }
    }
    s.tdy[u][g] = v;
  }
#pragma unroll 4
  for (int i = tid; i < kT * G; i += kTh) {  // along t when channel-major
    const int u = p.x_t ? i % kT : i / G, g = p.x_t ? i / kT : i % G;
    const long long t = t0 + u, d = d0 + g;
    s.x[u][g] = u < rows && d < p.D
                    ? E::load(xin + t * p.sx.t + d * p.sx.d) : 0.f;
  }
  for (int i = tid; i < kT * 2 * N; i += kTh) {
    const int u = i / (2 * N), k = i % (2 * N);
    s.bc[u][k] = u < rows ? E::load(bc + (t0 + u) * p.sp.t + k * p.sp.d) : 0.f;
  }
}

template <int N>
__device__ __forceinline__ void neg_a(const float* A_log, long long e,
                                      float (&A)[FusedBwdShape<N>::kS],
                                      float (&A2)[FusedBwdShape<N>::kS]) {
#pragma unroll
  for (int k = 0; k < FusedBwdShape<N>::kS; ++k) {
    A[k] = -expf(__ldg(A_log + e + k));
    A2[k] = A[k] * kLog2e;
  }
}

template <int N, typename T>
__global__ void __launch_bounds__(FusedBwdShape<N>::kThreads)
fused_bwd_sum_kernel(const FusedBwdArgs p) {
  using Sh = FusedBwdShape<N>;
  constexpr int G = Sh::kG, kS = Sh::kS, kL = Sh::kL, kT = Sh::kT;
  extern __shared__ float4 smem_f4[];
  auto& s = *reinterpret_cast<FusedBwdStage<N>*>(smem_f4);
  const int tid = threadIdx.x, g = tid / kL, l = tid % kL;
  const long long b = blockIdx.z, c = blockIdx.y, D = p.D;
  const long long d0 = static_cast<long long>(blockIdx.x) * G, d = d0 + g;
  const long long t0 = c * kT;
  const int rows = static_cast<int>(p.S - t0 < kT ? p.S - t0 : kT);
  const bool active = d < D;
  float A[kS], A2[kS];
  neg_a<N>(p.A_log, (active ? d : D - 1) * N + l * kS, A, A2);
  stage_chunk<N, T, true>(p, s, b, d0, t0, rows);
  __syncthreads();
  float hl[kS], P[kS], gr[kS], sd = 0.f;
#pragma unroll
  for (int k = 0; k < kS; ++k) {
    hl[k] = 0.f;
    P[k] = 1.f;
    gr[k] = 0.f;
  }
  // Every chunk walks kT steps: past S the staged zeros are the identity.
#pragma unroll 8
  for (int u = 0; u < kT; ++u) {
    const float2 v = s.tdy[u][g];
    const float dt = v.x, dy = v.y, dtx = dt * s.x[u][g];
    float Bn[kS], Cn[kS];
    lds_states<kS>(&s.bc[u][l * kS], Bn);
    lds_states<kS>(&s.bc[u][N + l * kS], Cn);
    sd += dt;
#pragma unroll
    for (int k = 0; k < kS; ++k) {
      const float ab = ex2(dt * A2[k]);
      hl[k] = fmaf(ab, hl[k], Bn[k] * dtx);
      P[k] *= ab;
      gr[k] = fmaf(P[k], dy * Cn[k], gr[k]);
    }
  }
  if (active) {
    const long long BCDN = p.B * p.C * D * N;
    const long long e = ((b * p.C + c) * D + d) * N + l * kS;
#pragma unroll
    for (int k = 0; k < kS; ++k) {
      p.sums[e + k] = hl[k];
      p.sums[BCDN + e + k] = gr[k];
    }
    if (l == 0) p.sums[2 * BCDN + (b * p.C + c) * D + d] = sd;
  }
}

// One thread a state and a direction: the first B*D*N threads walk the
// chunks forward (the carry-in states, from h0), the others backward (the
// adjoint carries, from 0). kCarryBatch chunks' summaries are loaded at
// once, then walked, so the walk's dependent chain waits on no load.
template <int N>
__global__ void __launch_bounds__(256)
fused_bwd_carry_kernel(const FusedBwdArgs p) {
  constexpr int kCarryBatch = 16;
  const long long j0 = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  const long long DN = p.D * N, C = p.C, BDN = p.B * DN;
  if (j0 >= 2 * BDN) return;
  const bool rev = j0 >= BDN;
  const long long i = rev ? j0 - BDN : j0;
  const long long b = i / DN, e = i % DN, BCDN = p.B * C * DN;
  const float A2 = -expf(__ldg(p.A_log + e)) * kLog2e;
  float* H = p.sums + (rev ? BCDN : 0) + b * C * DN + e;
  const float* sd = p.sums + 2 * BCDN + b * C * p.D + e / N;
  float h = !rev && p.h0 != nullptr ? __ldg(p.h0 + i) : 0.f;
  for (long long k0 = 0; k0 < C; k0 += kCarryBatch) {
    float loc[kCarryBatch], dec[kCarryBatch];
#pragma unroll
    for (int j = 0; j < kCarryBatch; ++j) {
      const long long k = rev ? C - 1 - (k0 + j) : k0 + j;
      const bool in = k0 + j < C;
      loc[j] = in ? H[k * DN] : 0.f;
      dec[j] = in ? ex2(A2 * sd[k * p.D]) : 1.f;
    }
#pragma unroll
    for (int j = 0; j < kCarryBatch; ++j) {
      const long long k = rev ? C - 1 - (k0 + j) : k0 + j;
      if (k0 + j < C) H[k * DN] = h;  // the chunk's carry, in place
      h = fmaf(dec[j], h, loc[j]);
    }
  }
}

template <int N, typename T>
__global__ void __launch_bounds__(FusedBwdShape<N>::kThreads, 1)
fused_bwd_kernel(const FusedBwdArgs p) {
  using Sh = FusedBwdShape<N>;
  using E = Elt<T>;
  constexpr int G = Sh::kG, kS = Sh::kS, kL = Sh::kL, kT = Sh::kT;
  constexpr int kQ = Sh::kQ, kTh = Sh::kThreads, kW = Sh::kWarps;
  constexpr int kEpi = Sh::kEpi, kStride = kTh / G;  // kStride == kL
  // The sums over d: 2kS rows over the warp's channel lanes (lane bits 16
  // down to kL); over n: kQ rows (steps) over a channel's kL lanes.
  constexpr int kDRows = lane_rows(2 * kS, 16, kL);
  constexpr int kDBits = butterfly_bits(2 * kS, 16, kL);
  constexpr int kNRows = lane_rows(kQ, kL / 2, 1);
  extern __shared__ float4 smem_f4[];
  auto& s = *reinterpret_cast<FusedBwdSmem<N>*>(smem_f4);
  const int tid = threadIdx.x, g = tid / kL, l = tid % kL;
  const int lane = tid % 32, warp = tid / 32;
  const long long b = blockIdx.z, c = blockIdx.y, D = p.D, S = p.S;
  const long long d0 = static_cast<long long>(blockIdx.x) * G, d = d0 + g;
  const long long t0 = c * kT, nblk = gridDim.x;
  const int rows = static_cast<int>(S - t0 < kT ? S - t0 : kT);
  const bool active = d < D;
  const long long BCDN = p.B * p.C * D * N;
  const long long e0 = ((b * p.C + c) * D + (active ? d : 0)) * N + l * kS;
  float A[kS], A2[kS], h[kS], gcar[kS], dA[kS];
  neg_a<N>(p.A_log, (active ? d : D - 1) * N + l * kS, A, A2);
#pragma unroll
  for (int k = 0; k < kS; ++k) {  // the carry kernel's carries
    h[k] = active ? p.sums[e0 + k] : 0.f;
    gcar[k] = active ? p.sums[BCDN + e0 + k] : 0.f;
    dA[k] = 0.f;
  }
  // Epilogue items: channel ge, steps ue0 + m*kStride of a sub-segment.
  const int ge = tid % G, ue0 = tid / G;
  const long long de = d0 + ge;
  const bool eact = de < D;
  const float dsk = eact ? E::rnd(__ldg(p.Dskip + de)) : 0.f;
  const T* gyp = static_cast<const T*>(p.gy) + b * p.sgy.b + de * p.sgy.d;
  const auto* dsg = static_cast<const typename Pair<T>::W*>(p.dsg) +
                    b * S * D + de;
  float cdsk = 0.f, cbias = 0.f;

  stage_chunk<N, T, false>(p, s, b, d0, t0, rows);
  __syncthreads();
  // Forward from the carry-in: the state at each sub-segment's start.
  for (int q = 0; q <= (rows - 1) / kQ; ++q) {
#pragma unroll
    for (int k = 0; k < kS; ++k) s.hb[q][k][tid] = h[k];
#pragma unroll
    for (int u = q * kQ; u < q * kQ + kQ; ++u) {  // past S: the identity
      const float dt = s.tdy[u][g].x, dtx = dt * s.x[u][g];
      float Bn[kS];
      lds_states<kS>(&s.bc[u][l * kS], Bn);
#pragma unroll
      for (int k = 0; k < kS; ++k)
        h[k] = fmaf(ex2(dt * A2[k]), h[k], Bn[k] * dtx);
    }
  }

  for (int q = (rows - 1) / kQ; q >= 0; --q) {
    const int u0 = q * kQ, len = rows - u0 < kQ ? rows - u0 : kQ;
    auto& ns = s.ns[q & 1];
    auto& dsum = s.dsum[q & 1];
    // The epilogue's inputs, loaded before the walk that hides them.
    float egy[kEpi];
    float2 efac[kEpi];  // (dsil, sgs)
#pragma unroll
    for (int m = 0; m < kEpi; ++m) {
      const int ue = ue0 + m * kStride;
      const long long t = t0 + u0 + ue;
      const bool ok = ue < len && eact;
      egy[m] = ok ? E::load(gyp + t * p.sgy.t) : 0.f;
      efac[m] = ok ? Pair<T>::unpack(dsg[t * D]) : make_float2(0.f, 0.f);
    }
    // The sub-segment's states again, into registers, and y32's partials.
    float hs[kQ + 1][kS], ab[kQ][kS], yq[kQ];
#pragma unroll
    for (int k = 0; k < kS; ++k) hs[0][k] = s.hb[q][k][tid];
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      yq[u] = 0.f;
      const int uu = u0 + u;  // past len: staged zeros, the identity step
      const float dt = s.tdy[uu][g].x, dtx = dt * s.x[uu][g];
      float Bn[kS], Cn[kS];
      lds_states<kS>(&s.bc[uu][l * kS], Bn);
      lds_states<kS>(&s.bc[uu][N + l * kS], Cn);
#pragma unroll
      for (int k = 0; k < kS; ++k) {
        ab[u][k] = ex2(dt * A2[k]);
        hs[u + 1][k] = fmaf(ab[u][k], hs[u][k], Bn[k] * dtx);
        yq[u] = fmaf(hs[u + 1][k], Cn[k], yq[u]);
      }
    }
    {
      const int r0 = lane_reduce<kQ, kL / 2, 1>(yq, l);
#pragma unroll
      for (int k = 0; k < kNRows; ++k) ns[0][r0 + k][g] = yq[k];
    }
    // The adjoint back over the sub-segment; steps past len are the
    // identity (staged zeros) and their rows are not read.
    float aq[kQ], bq[kQ];
#pragma unroll
    for (int u = kQ - 1; u >= 0; --u) {
      aq[u] = 0.f;
      bq[u] = 0.f;
      const int uu = u0 + u;
      const float2 v = s.tdy[uu][g];
      const float dt = v.x, dy = v.y, dtx = dt * s.x[uu][g];
      float Bn[kS], Cn[kS], pd[2 * kS];
      lds_states<kS>(&s.bc[uu][l * kS], Bn);
      lds_states<kS>(&s.bc[uu][N + l * kS], Cn);
#pragma unroll
      for (int k = 0; k < kS; ++k) {
        const float gk = fmaf(dy, Cn[k], gcar[k]);
        const float dlin = gk * hs[u][k] * ab[u][k];  // dL/d(dt A)
        dA[k] = fmaf(dlin, dt, dA[k]);
        aq[u] = fmaf(dlin, A[k], aq[u]);
        bq[u] = fmaf(gk, Bn[k], bq[u]);
        pd[k] = gk * dtx;               // dBc
        pd[kS + k] = dy * hs[u + 1][k];  // dCc
        gcar[k] = ab[u][k] * gk;
      }
      const int r0 = lane_reduce<2 * kS, 16, kL>(pd, lane);
      if ((lane & kDBits) == 0) {
#pragma unroll
        for (int k = 0; k < kDRows; ++k) {
          const int row = r0 + k;  // (dBc | dCc, state l*kS + row % kS)
          dsum[u][warp][(row < kS ? 0 : N) + l * kS + row % kS] = pd[k];
        }
      }
    }
    {
      const int r0 = lane_reduce<kQ, kL / 2, 1>(aq, l);
      lane_reduce<kQ, kL / 2, 1>(bq, l);
#pragma unroll
      for (int k = 0; k < kNRows; ++k) {
        ns[1][r0 + k][g] = aq[k];
        ns[2][r0 + k][g] = bq[k];
      }
    }
    __syncthreads();
    // The epilogue along d.
#pragma unroll
    for (int m = 0; m < kEpi; ++m) {
      const int ue = ue0 + m * kStride, uu = u0 + ue;
      if (ue >= len || !eact) continue;
      const float x = s.x[uu][ge], dt = s.tdy[uu][ge].x;
      const float dyp = s.tdy[uu][ge].y;
      const float gB = ns[2][ue][ge];
      const float ddt = fmaf(x, gB, ns[1][ue][ge]);
      const float dx = dt * gB;
      const float ypre = E::rnd(__fadd_rn(E::rnd(ns[0][ue][ge]),
                                          E::rnd(__fmul_rn(dsk, x))));
      const long long o = (b * S + t0 + uu) * D + de;
      E::store(static_cast<T*>(p.dz) + o,
               __fmul_rn(E::rnd(__fmul_rn(egy[m], ypre)), efac[m].x));
      E::store(static_cast<T*>(p.dxin) + o,
               __fadd_rn(E::rnd(__fmul_rn(dyp, dsk)), E::rnd(dx)));
      const float ds = E::rnd(__fmul_rn(E::rnd(ddt), efac[m].y));
      E::store(static_cast<T*>(p.ddt) + o, ds);
      cbias += ds;
      cdsk += E::rnd(__fmul_rn(dyp, x));
    }
    // The sub-segment's sums over d: the block's warps in order.
    for (int i = tid; i < len * 2 * N; i += kTh) {
      const int u = i / (2 * N), col = i % (2 * N);
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kW; ++w) v += dsum[u][w][col];
      p.part[((b * S + t0 + u0 + u) * nblk + blockIdx.x) * 2 * N + col] = v;
    }
  }
  if (active) {
#pragma unroll
    for (int k = 0; k < kS; ++k) {
      p.dApart[e0 + k] = dA[k];
      if (c == 0 && p.dh0 != nullptr)
        p.dh0[(b * D + d) * N + l * kS + k] = gcar[k];  // Abar_0 g_0
    }
  }
  // dDskip and ddt_bias: a channel's kStride threads in order.
  float(&red)[2][kStride][G + 4] =
      *reinterpret_cast<float(*)[2][kStride][G + 4]>(&s.ns[0][0][0][0]);
  __syncthreads();  // the last epilogue has read ns
  red[0][ue0][ge] = cdsk;
  red[1][ue0][ge] = cbias;
  __syncthreads();
  if (ue0 == 0 && eact) {
    const long long BC = p.B * p.C;
#pragma unroll
    for (int kind = 0; kind < 2; ++kind) {
      float v = 0.f;
#pragma unroll
      for (int m = 0; m < kStride; ++m) v += red[kind][m][ge];
      p.chan[(kind * BC + b * p.C + c) * D + de] = v;
    }
  }
}

// dproj's rows from part: columns below r are 0, column r + k the sum over
// the blocks' partials of k in block order, rounded to T.
template <typename T>
__global__ void __launch_bounds__(256)
proj_grad_kernel(const float* __restrict__ part, T* __restrict__ dproj,
                 long long rows, long long r, int two_n, int nblk) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  const long long width = r + two_n;
  if (i >= rows * width) return;
  const long long row = i / width, col = i % width;
  float v = 0.f;
  if (col >= r) {
    const float* q = part + row * nblk * two_n + (col - r);
    for (long long k = 0; k < nblk; ++k) v += __ldg(q + k * two_n);
  }
  Elt<T>::store(dproj + i, v);
}

template <int N, typename T>
cudaError_t launch_fused_bwd(const FusedBwdArgs& a, float* dA, float* dchan,
                             cudaStream_t st) {
  using Sh = FusedBwdShape<N>;
  const long long nblk = (a.D + Sh::kG - 1) / Sh::kG;
  if (nblk > INT_MAX || a.C > 65535 || a.B > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(nblk), static_cast<unsigned>(a.C),
                  static_cast<unsigned>(a.B));
  constexpr int s1 = sizeof(FusedBwdStage<N>), s2 = sizeof(FusedBwdSmem<N>);
  cudaError_t err = cudaFuncSetAttribute(
      fused_bwd_sum_kernel<N, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      s1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fused_bwd_kernel<N, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, s2);
  if (err != cudaSuccess) return err;
  fused_bwd_sum_kernel<N, T><<<grid, Sh::kThreads, s1, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long states = 2 * a.B * a.D * N;  // two directions
  if ((states + 255) / 256 > INT_MAX) return cudaErrorInvalidValue;
  fused_bwd_carry_kernel<N>
      <<<static_cast<unsigned>((states + 255) / 256), 256, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fused_bwd_kernel<N, T><<<grid, Sh::kThreads, s2, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long outs = a.B * a.S * (a.r + 2 * N);
  if ((outs + 255) / 256 > INT_MAX) return cudaErrorInvalidValue;
  proj_grad_kernel<T><<<static_cast<unsigned>((outs + 255) / 256), 256, 0,
                        st>>>(a.part, static_cast<T*>(a.dproj), a.B * a.S,
                              a.r, 2 * N, static_cast<int>(nblk));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = ckio::ordered_sum(a.dApart, dA, 1, a.B * a.C, a.D * N, st);
  if (err != cudaSuccess) return err;
  return ckio::ordered_sum(a.chan, dchan, 2, a.B * a.C, a.D, st);
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

// The fused entry's gradient. gy, xin, dt_pre, z: (B,S,D); proj:
// (B,S,r+2N); each of the five with its (b, t, d) element strides in
// strides[0..14], in that order, in the compute dtype (bf16 when bf16 != 0,
// else fp32). dt_bias, Dskip: (D); A_log: (D,N); h0: (B,D,N) or null; all
// fp32, contiguous. Writes dxin, ddt_pre, dz (B,S,D) and dproj (B,S,r+2N),
// contiguous in the compute dtype; dA (D,N) = dL/dA with A = -exp(A_log),
// dchan (2,D) = the fp32 sums of dDskip's and ddt_bias's terms; dh0 (B,D,N)
// when not null. Scratch (floats), C = ceil(S/64), G = 64 at N = 32, else
// 128: sums B*C*D*(2N+1), part B*S*ceil(D/G)*2N, dApart B*C*D*N, chan
// 2*B*C*D, planes 2*B*S*D (bf16) or 4*B*S*D (fp32).
extern "C" int ckio_mamba_scan_fused_backward(
    const void* gy, const void* xin, const void* dt_pre, const void* z,
    const void* proj, const float* dt_bias, const float* A_log,
    const float* Dskip, const float* h0, void* dxin, void* ddt, void* dz,
    void* dproj, float* dh0, float* sums, float* part, float* dApart,
    float* chan, void* planes, float* dA, float* dchan, long long B,
    long long S, long long D, int N, long long r, int bf16,
    const long long* strides, void* stream) {
  if (B < 1 || S < 1 || D < 1 || r < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  FusedBwdArgs a{};
  a.gy = gy; a.xin = xin; a.dtp = dt_pre; a.z = z; a.proj = proj;
  a.dt_bias = dt_bias; a.A_log = A_log; a.Dskip = Dskip; a.h0 = h0;
  a.dxin = dxin; a.ddt = ddt; a.dz = dz; a.dproj = dproj; a.dh0 = dh0;
  a.sums = sums; a.part = part; a.dApart = dApart; a.chan = chan;
  // planes: tdy, then dsg, B*S*D words of 4 (bf16) or 8 (fp32) bytes each,
  // 8-byte aligned.
  a.tdy = planes;
  a.dsg = static_cast<char*>(planes) + B * S * D * (bf16 ? 4 : 8);
  a.B = B; a.S = S; a.D = D; a.r = r; a.C = (S + 63) / 64;
  View3* views[5] = {&a.sgy, &a.sx, &a.sdt, &a.sz, &a.sp};
  for (int i = 0; i < 5; ++i)
    *views[i] = View3{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.x_t = a.sx.t == 1 && a.sx.d != 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (N) {
#define CKIO_FBWD(n)                                                      \
  case n:                                                                 \
    err = bf16 ? launch_fused_bwd<n, __nv_bfloat16>(a, dA, dchan, st)     \
               : launch_fused_bwd<n, float>(a, dA, dchan, st);            \
    break;
    CKIO_FBWD(1) CKIO_FBWD(2) CKIO_FBWD(4) CKIO_FBWD(8) CKIO_FBWD(16)
    CKIO_FBWD(32)
#undef CKIO_FBWD
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
