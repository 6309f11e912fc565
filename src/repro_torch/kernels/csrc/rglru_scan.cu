// RG-LRU linear recurrence on an NVIDIA Hopper card (sm_90a), literal and
// gated.
//
// Two kernel templates with a plain C interface (loaded through ctypes by
// repro_torch/kernels/rglru_scan.py), each in two instances. The launchers
// enqueue on the stream they are given, allocate nothing, and return
// cudaGetLastError() so that a refused launch is reported at the call.
//
// lru_kernel<float, false>, ckio_rglru_scan — replaces rglru_scan_pallas
//   (src/repro/kernels/rglru_scan.py, _lru_kernel). a, b (B,S,W), fp32,
//   contiguous:
//     h_t[w] = a_t[w] * h_{t-1}[w] + b_t[w]          -> h (B,S,W) fp32
//   from h_{-1} = h0 (B,W) when given, else 0 (the Pallas function). Every
//   h_t is written; h[:, S-1] is the final state.
//
//   Bound: bytes. 12*B*S*W (+ 4*B*W for h0) over 3.35 TB/s: 503 MB ->
//   0.150 ms at B=8, S=2048, W=2560; at decode (B=1, S=1, W=2560) 31 KB,
//   where the launch is the floor.
//
// lru_kernel<T, true>, ckio_rglru_scan_gated — the same recurrence with an
//   RG-LRU layer's gates and output product fused in: what the model's
//   _gates, the scan and y = h.to(dtype) * gate computed in about 16
//   launches. From the fp32 gate products r_pre, i_pre (B,S,W), fp32 b_r,
//   b_i, lam (W), the conv output xr and the GeLU gate in the compute dtype
//   T (bf16 or fp32, each read through its strides) and h0 (B,W):
//     r = sigmoid(r_pre + b_r),  i = sigmoid(i_pre + b_i)
//     log_a = (-8 softplus(lam)) * r,  a = exp(log_a)
//     beta = sqrt(max(1 - exp(2 log_a), 1e-12)),  x = (beta * i) * xr
//     h = fma(a, h, x),  y = rnd(rnd(h) * gate)    -> y (B,S,W) in T
//   and the final state h_S (B,W) fp32 when asked (nothing else reads every
//   h, so it is not written). Products and sums that torch rounds are
//   __fmul_rn / __fadd_rn, so that nvcc contracts none into an FMA.
//
//   Bound: bytes, 4+4+2+2+2 = 14 B an element in bf16: 587 MB -> 0.175 ms
//   at B=8, S=2048, W=2560; about 7 transcendental ops an element
//   (0.07 ms at 16 a clock an SM).
//
// Design: a one-pass chunked scan. A block is kLanes channels (threadIdx.x,
//   neighbouring w, so a warp reads 128 contiguous bytes a step) by kChunks
//   chunks of kQ consecutive steps (threadIdx.y), and walks the sequence in
//   segments of kChunks*kQ steps. In a segment each thread loads its kQ
//   steps at once (2*kQ loads in flight, 4*kQ when gated), runs them from
//   h = 0 in registers, keeping each step's prefix product cumA_t and local
//   state, and parks its chunk's (cumA, local end) in shared memory. After
//   one barrier a chunk takes its carry-in by walking the earlier chunks'
//   summaries in index order from the segment's carry, and finishes from
//   registers: h_t = fma(cumA_t, carry, local_t). The thread that holds
//   the segment's last step hands its h to the next segment. Each input
//   is read once and each output written once, with S/kQ-fold more work in
//   flight than a thread walking all of S. kQ, kChunks and the walk order
//   are constants, so a row has the same bits at every B and on every run.
//   xr's kQ steps are one 16-byte load where it is channel-major (the conv's
//   layout). Any B, S and W: channels past B*W shadow the last one (no
//   stores) and steps past S are the identity (a = 1, b = 0). Offsets are
//   64-bit.
//
//   At S = 1 (every decode step) lru_step_kernel runs instead: one thread a
//   channel, h = fma(a, h0, b), the same bits as lru_kernel's one-step
//   sequence (cumA = a, local = b) with no barrier and no idle chunk.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_math.cuh"

namespace {

using ckio::Elt;
using ckio::sigmoid_f;
using ckio::softplus_f;
using ckio::View3;

constexpr int kLanes = 32;   // channels a block
constexpr int kChunks = 16;  // chunks a block
constexpr int kQ = 8;        // steps a chunk
constexpr int kStepThreads = 256;  // channels a block of the S = 1 kernel
constexpr int kSeg = kChunks * kQ;

struct LruArgs {
  const float* a;     // literal: a;  gated: r_pre
  const float* b;     // literal: b;  gated: i_pre
  const void* xr;     // gated only
  const void* gate;   // gated only
  const float* b_r;
  const float* b_i;
  const float* lam;
  const float* h0;
  void* out;          // literal: every h (fp32);  gated: y (T)
  float* hS;
  long long B, S, W;
  View3 sxr, sg;      // strides of xr and gate
  int vec_xr;         // xr's steps are contiguous and 16-byte aligned
};

// kQ steps of one channel from p (stride st between steps), n of them
// valid: 16-byte loads where the steps are contiguous and aligned (xr as
// the conv leaves it, channel-major), else one load a step.
template <typename T>
__device__ __forceinline__ void load_steps(const T* p, long long st,
                                           long long n, bool vec,
                                           float (&out)[kQ]) {
  using E = Elt<T>;
  if (vec && n >= kQ) {
#pragma unroll
    for (int v = 0; v < kQ; v += E::kVec) E::load_vec(p + v, out + v);
    return;
  }
#pragma unroll
  for (int u = 0; u < kQ; ++u) out[u] = u < n ? E::load(p + u * st) : 0.f;
}

// One step's decay and input from the gate products, as torch rounds them.
struct Gate {
  float neg_c_sp = 0.f, br = 0.f, bi = 0.f;  // -8 softplus(lam), b_r, b_i

  __device__ static Gate of(const LruArgs& p, long long w) {
    Gate g;
    g.neg_c_sp = __fmul_rn(-8.f, softplus_f(__ldg(p.lam + w)));
    g.br = __ldg(p.b_r + w);
    g.bi = __ldg(p.b_i + w);
    return g;
  }
  __device__ void operator()(float rp, float ip, float x, float& a,
                             float& b) const {
    const float r = sigmoid_f(__fadd_rn(rp, br));
    const float i = sigmoid_f(__fadd_rn(ip, bi));
    const float log_a = __fmul_rn(neg_c_sp, r);
    a = expf(log_a);
    b = __fmul_rn(
        __fmul_rn(sqrtf(fmaxf(__fsub_rn(1.f, expf(2.f * log_a)), 1e-12f)), i),
        x);
  }
};

// S = 1, a decode step: one thread a channel, h = fma(a, h0, b), which is
// what lru_kernel computes for a one-step sequence (cumA = a, local = b).
template <typename T, bool kGated>
__global__ void __launch_bounds__(kStepThreads)
lru_step_kernel(const LruArgs p) {
  using E = Elt<T>;
  const long long c = static_cast<long long>(blockIdx.x) * kStepThreads +
                      threadIdx.x;
  if (c >= p.B * p.W) return;
  float a, b;
  if (kGated) {
    const long long bi = c / p.W, w = c % p.W;
    Gate::of(p, w)(__ldg(p.a + c), __ldg(p.b + c),
               E::load(static_cast<const T*>(p.xr) + bi * p.sxr.b +
                       w * p.sxr.d), a, b);
  } else {
    a = __ldg(p.a + c);
    b = __ldg(p.b + c);
  }
  const float h = fmaf(a, p.h0 != nullptr ? __ldg(p.h0 + c) : 0.f, b);
  if (kGated) {
    const long long bi = c / p.W, w = c % p.W;
    const float g = E::load(static_cast<const T*>(p.gate) + bi * p.sg.b +
                            w * p.sg.d);
    E::store(static_cast<T*>(p.out) + c, __fmul_rn(E::rnd(h), g));
    if (p.hS != nullptr) p.hS[c] = h;
  } else {
    static_cast<float*>(p.out)[c] = h;
  }
}

// Two blocks an SM for both instances: 64 registers. The gated one then
// spills 72-80 B, yet runs faster than in one block an SM with 106-118
// registers and no spill (0.374 against 0.471 ms at B=8, S=2048, bf16).
template <typename T, bool kGated>
__global__ void __launch_bounds__(kLanes * kChunks, 2)
lru_kernel(const LruArgs p) {
  using E = Elt<T>;
  __shared__ float s_a[kChunks][kLanes], s_h[kChunks][kLanes];
  __shared__ float s_carry[kLanes];
  const int x = threadIdx.x, j = threadIdx.y;
  const long long S = p.S, W = p.W, channels = p.B * W;
  const long long c = static_cast<long long>(blockIdx.x) * kLanes + x;
  const bool active = c < channels;
  const long long cc = active ? c : channels - 1;  // shadow the last channel
  const long long bi = cc / W, w = cc % W;
  const long long base = bi * S * W + w;  // element (bi, 0, w), contiguous
  const T* xr = static_cast<const T*>(p.xr);
  const T* gate = static_cast<const T*>(p.gate);

  Gate gt;  // per channel, once
  if (kGated) gt = Gate::of(p, w);
  float carry = p.h0 != nullptr ? __ldg(p.h0 + cc) : 0.f;

  for (long long s0 = 0; s0 < S; s0 += kSeg) {
    const long long t1 = s0 + static_cast<long long>(j) * kQ;
    const long long last = (S < s0 + kSeg ? S : s0 + kSeg) - 1;
    float av[kQ], bv[kQ];
    if (!kGated) {
#pragma unroll
      for (int u = 0; u < kQ; ++u) {
        const long long t = t1 + u;
        av[u] = t < S ? __ldg(p.a + base + t * W) : 1.f;
        bv[u] = t < S ? __ldg(p.b + base + t * W) : 0.f;
      }
    } else {
      float rp[kQ], ip[kQ], xv[kQ];
#pragma unroll
      for (int u = 0; u < kQ; ++u) {
        const long long t = t1 + u;
        rp[u] = t < S ? __ldg(p.a + base + t * W) : 0.f;
        ip[u] = t < S ? __ldg(p.b + base + t * W) : 0.f;
      }
      load_steps(xr + bi * p.sxr.b + t1 * p.sxr.t + w * p.sxr.d, p.sxr.t,
                 S - t1, p.vec_xr != 0, xv);
#pragma unroll
      for (int u = 0; u < kQ; ++u) {
        gt(rp[u], ip[u], xv[u], av[u], bv[u]);
        if (t1 + u >= S) {  // past the end: the identity
          av[u] = 1.f;
          bv[u] = 0.f;
        }
      }
    }
    // The chunk from h = 0: prefix products and local states.
    float cum[kQ], loc[kQ];
    float ca = 1.f, lh = 0.f;
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      lh = fmaf(av[u], lh, bv[u]);
      ca = __fmul_rn(av[u], ca);
      cum[u] = ca;
      loc[u] = lh;
    }
    s_a[j][x] = ca;
    s_h[j][x] = lh;
    float gv[kQ];
    if (kGated) {
#pragma unroll
      for (int u = 0; u < kQ; ++u) {
        const long long t = t1 + u;
        gv[u] = t < S ? E::load(gate + bi * p.sg.b + t * p.sg.t + w * p.sg.d)
                      : 0.f;
      }
    }
    __syncthreads();
    float cin = carry;  // walk the earlier chunks in index order
    for (int k = 0; k < j; ++k) cin = fmaf(s_a[k][x], cin, s_h[k][x]);
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      const long long t = t1 + u;
      const float hv = fmaf(cum[u], cin, loc[u]);
      if (t == last) s_carry[x] = hv;
      if (t < S && active) {
        if (kGated) {
          E::store(static_cast<T*>(p.out) + base + t * W,
                   __fmul_rn(E::rnd(hv), gv[u]));
        } else {
          static_cast<float*>(p.out)[base + t * W] = hv;
        }
      }
    }
    __syncthreads();
    carry = s_carry[x];
  }
  if (p.hS != nullptr && active) p.hS[c] = carry;
}

template <typename T, bool kGated>
cudaError_t launch(const LruArgs& a, cudaStream_t st) {
  if (a.S == 1) {
    const long long blocks = (a.B * a.W + kStepThreads - 1) / kStepThreads;
    if (blocks > INT_MAX) return cudaErrorInvalidValue;
    lru_step_kernel<T, kGated>
        <<<static_cast<unsigned>(blocks), kStepThreads, 0, st>>>(a);
    return cudaGetLastError();
  }
  const long long blocks = (a.B * a.W + kLanes - 1) / kLanes;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  lru_kernel<T, kGated><<<static_cast<unsigned>(blocks), dim3(kLanes, kChunks),
                          0, st>>>(a);
  return cudaGetLastError();
}

// -- backward -----------------------------------------------------------------
// lru_bwd_kernel — the gradient of the gated entry (lru_kernel<T, true>).
//   No TPU kernel: the reference differentiates _gates and the associative
//   scan (src/repro/models/rglru.py) with XLA. With gh_t = rnd(gy_t gate_t):
//     g_t = gh_t + a_{t+1} g_{t+1},  dh0 = a_0 g_0,  dgate_t = rnd(gy_t rnd(h_t))
//     dlog_a = g h_{t-1} a + [1 - e2 >= 1e-12] 2 (-(g x i / (2 beta)) e2)
//     dr_pre = dlog_a c r (1 - r),  di_pre = g x beta i (1 - i),
//     dxr = rnd(g beta i),  dc += dlog_a r
//   (c = -8 softplus(lam), e2 = exp(2 log_a), x = xr in fp32), each product
//   in the order torch's autograd takes it; the wrapper turns dc into dlam.
//
//   Bound: bytes. r_pre, i_pre read and dr_pre, di_pre written (4 B each),
//   xr, gate, gy read and dxr, dgate written (2 B each in bf16): 26 B an
//   element, 273 MB -> 0.081 ms at B=2, S=2048, W=2560.
//
//   Design: lru_kernel's layout, a block of kBwdLanes channels by kChunks
//   chunks of kQ steps, so that B*W*kChunks threads share the work where
//   one thread a channel walked S serially (5,120 threads at the bound's
//   shape, 40 SMs). 16 channels a block (a warp spans two chunks, 64
//   contiguous bytes of r_pre a step) give 320 blocks there, four an SM,
//   against 160 blocks of 32 channels. Two walks over the segments of kSeg
//   steps:
//   (1) forward: lru_kernel's chunk summaries (cumA, local end) and its
//       carry walk in index order, which keep the segment-start state in
//       hseg (B, ceil(S/kSeg), W); the same kQ, kChunks and order give
//       the forward's own h bits;
//   (2) backward, segments from the last to the first: a thread loads its
//       kQ steps at once (xr in 16-byte loads where channel-major), forms
//       the gates, its chunk's summaries from zero in both directions --
//       cumA_t and the local states as (1), and the reverse local adjoint
//       G = sum_u cumA_u gh_u (= a_{t1} g_{t1} from g = 0 past the chunk)
//       -- and parks (cumA, local end, G) in shared memory. After one
//       barrier a chunk walks the earlier chunks forward from hseg for its
//       carry-in, h_t = fma(cumA_t, carry, local_t) as lru_kernel, and the
//       later chunks backward from the next segment's a*g for its adjoint
//       carry, then runs g_t = gh_t + a_{t+1} g_{t+1} over its kQ steps and
//       writes dr_pre, di_pre, dxr and dgate once. The gate inputs are read
//       again there (L1-resident) rather than held: four blocks an SM
//       leave 64 registers a thread.
//   The summaries are double-buffered by segment parity, so a segment needs
//   one barrier. db_r, db_i and dc sum over a thread's chunk, then over the
//   chunks in index order, then over B (ordered_sum_kernel). Every order is
//   fixed: the same bits on every run.
struct LruBwdArgs {
  const float* r_pre;
  const float* i_pre;
  const void* xr;
  const void* gate;
  const void* gy;
  const float* b_r;
  const float* b_i;
  const float* lam;
  const float* h0;
  float* dr;           // (B,S,W) fp32, contiguous
  float* di;
  void* dxr;           // (B,S,W) contiguous, compute dtype
  void* dgate;
  float* dh0;
  float* hseg;         // (B, ceil(S/kSeg), W): the state at each segment start
  float* part;         // (3, B, W): dc, db_r, db_i
  long long B, S, W;
  View3 sxr, sg, sgy;  // strides of xr, gate and gy
  int vec_xr;
};

constexpr int kBwdLanes = 16;  // channels a block of lru_bwd_kernel

template <typename T>
__global__ void __launch_bounds__(kBwdLanes * kChunks, 4)
lru_bwd_kernel(const LruBwdArgs p) {
  using E = Elt<T>;
  __shared__ float s_a[2][kChunks][kBwdLanes], s_h[2][kChunks][kBwdLanes];
  __shared__ float s_g[2][kChunks][kBwdLanes];
  __shared__ float s_red[3][kChunks][kBwdLanes];
  const int x = threadIdx.x, j = threadIdx.y;
  const long long S = p.S, W = p.W, channels = p.B * W;
  const long long c = static_cast<long long>(blockIdx.x) * kBwdLanes + x;
  const bool active = c < channels;
  const long long cc = active ? c : channels - 1;  // shadow the last channel
  const long long bi = cc / W, w = cc % W;
  const long long base = bi * S * W + w;  // element (bi, 0, w), contiguous
  const long long nseg = (S + kSeg - 1) / kSeg;
  float* hseg = p.hseg + bi * nseg * W + w;
  const T* xr = static_cast<const T*>(p.xr) + bi * p.sxr.b + w * p.sxr.d;
  const T* gate = static_cast<const T*>(p.gate) + bi * p.sg.b + w * p.sg.d;
  const T* gy = static_cast<const T*>(p.gy) + bi * p.sgy.b + w * p.sgy.d;
  LruArgs ga{};
  ga.b_r = p.b_r; ga.b_i = p.b_i; ga.lam = p.lam;
  const Gate gt = Gate::of(ga, w);

  // (1) the forward's segment-start states.
  float carry = p.h0 != nullptr ? __ldg(p.h0 + cc) : 0.f;
  for (long long k = 0; k < nseg; ++k) {
    const int buf = static_cast<int>(k & 1);
    const long long t1 = k * kSeg + static_cast<long long>(j) * kQ;
    if (j == 0 && active) hseg[k * W] = carry;
    float rp[kQ], ip[kQ], xv[kQ];
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      const long long t = t1 + u;
      rp[u] = t < S ? __ldg(p.r_pre + base + t * W) : 0.f;
      ip[u] = t < S ? __ldg(p.i_pre + base + t * W) : 0.f;
    }
    load_steps(xr + t1 * p.sxr.t, p.sxr.t, S - t1, p.vec_xr != 0, xv);
    float ca = 1.f, lh = 0.f;
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      float a, b;
      gt(rp[u], ip[u], xv[u], a, b);
      if (t1 + u >= S) {  // past the end: the identity
        a = 1.f;
        b = 0.f;
      }
      lh = fmaf(a, lh, b);
      ca = __fmul_rn(a, ca);
    }
    s_a[buf][j][x] = ca;
    s_h[buf][j][x] = lh;
    __syncthreads();
    // lru_kernel's carry: the walk over every chunk in index order (its
    // last step's h is fma(cumA, carry-in, local) of the last chunk).
#pragma unroll
    for (int m = 0; m < kChunks; ++m)
      carry = fmaf(s_a[buf][m][x], carry, s_h[buf][m][x]);
  }
  __syncthreads();  // (2) reuses the summaries' buffers

  // (2) the segments from the last to the first.
  float gcarry = 0.f;  // a_t g_t at the next segment's first step
  float sc = 0.f, sbr = 0.f, sbi = 0.f;
  for (long long k = nseg - 1; k >= 0; --k) {
    const int buf = static_cast<int>(k & 1);
    const long long t1 = k * kSeg + static_cast<long long>(j) * kQ;
    float a[kQ], cum[kQ], loc[kQ], gh[kQ];
    {
      float rp[kQ], ip[kQ], xv[kQ];
#pragma unroll
      for (int u = 0; u < kQ; ++u) {
        const long long t = t1 + u;
        rp[u] = t < S ? __ldg(p.r_pre + base + t * W) : 0.f;
        ip[u] = t < S ? __ldg(p.i_pre + base + t * W) : 0.f;
        gh[u] = t < S ? E::rnd(__fmul_rn(E::load(gy + t * p.sgy.t),
                                         E::load(gate + t * p.sg.t)))
                      : 0.f;
      }
      load_steps(xr + t1 * p.sxr.t, p.sxr.t, S - t1, p.vec_xr != 0, xv);
      float ca = 1.f, lh = 0.f, G = 0.f;
#pragma unroll
      for (int u = 0; u < kQ; ++u) {
        float b;
        gt(rp[u], ip[u], xv[u], a[u], b);
        if (t1 + u >= S) {
          a[u] = 1.f;
          b = 0.f;
        }
        lh = fmaf(a[u], lh, b);
        ca = __fmul_rn(a[u], ca);
        cum[u] = ca;
        loc[u] = lh;
        G = fmaf(ca, gh[u], G);  // sum_u cumA_u gh_u: a_{t1} g_{t1} from 0
      }
      s_a[buf][j][x] = ca;
      s_h[buf][j][x] = lh;
      s_g[buf][j][x] = G;
    }
    const float hs = hseg[k * W];  // written in (1), before its barriers
    __syncthreads();
    float cin = hs;
    for (int m = 0; m < j; ++m) cin = fmaf(s_a[buf][m][x], cin, s_h[buf][m][x]);
    float gc = gcarry;
    for (int m = kChunks - 1; m > j; --m)
      gc = fmaf(s_a[buf][m][x], gc, s_g[buf][m][x]);
#pragma unroll
    for (int m = kChunks - 1; m >= 0; --m)  // the earlier segment's carry
      gcarry = fmaf(s_a[buf][m][x], gcarry, s_g[buf][m][x]);
    float hv[kQ];  // lru_kernel's h bits
#pragma unroll
    for (int u = 0; u < kQ; ++u) hv[u] = fmaf(cum[u], cin, loc[u]);
#pragma unroll
    for (int u = kQ - 1; u >= 0; --u) {
      const long long t = t1 + u;
      if (t >= S) continue;
      const long long e = base + t * W;
      // The gate inputs again (L1-resident): two blocks an SM leave 64
      // registers a thread, too few to hold them through the walks.
      const float xu = E::load(xr + t * p.sxr.t);
      const float r = sigmoid_f(__fadd_rn(__ldg(p.r_pre + e), gt.br));
      const float i = sigmoid_f(__fadd_rn(__ldg(p.i_pre + e), gt.bi));
      const float log_a = __fmul_rn(gt.neg_c_sp, r);
      const float e2 = expf(2.f * log_a);
      const float inner = __fsub_rn(1.f, e2);
      const float beta = sqrtf(fmaxf(inner, 1e-12f));
      const float g = __fadd_rn(gh[u], gc);
      const float hp = u > 0 ? hv[u - 1] : cin;
      const float gx = __fmul_rn(g, xu);
      float dlog = __fmul_rn(__fmul_rn(g, hp), a[u]);
      if (inner >= 1e-12f) {
        const float dinner = __fdiv_rn(__fmul_rn(gx, i), __fmul_rn(2.f, beta));
        dlog = __fadd_rn(dlog, __fmul_rn(2.f, __fmul_rn(-dinner, e2)));
      }
      const float drp = __fmul_rn(
          __fmul_rn(__fmul_rn(dlog, gt.neg_c_sp), __fsub_rn(1.f, r)), r);
      const float dip =
          __fmul_rn(__fmul_rn(__fmul_rn(gx, beta), __fsub_rn(1.f, i)), i);
      sc += __fmul_rn(dlog, r);
      sbr += drp;
      sbi += dip;
      if (active) {
        p.dr[e] = drp;
        p.di[e] = dip;
        E::store(static_cast<T*>(p.dxr) + e, __fmul_rn(g, __fmul_rn(beta, i)));
        E::store(static_cast<T*>(p.dgate) + e,
                 __fmul_rn(E::load(gy + t * p.sgy.t), E::rnd(hv[u])));
      }
      gc = __fmul_rn(a[u], g);
    }
  }
  if (j == 0 && active && p.dh0 != nullptr) p.dh0[c] = gcarry;  // a_0 g_0
  // The chunks' sums in index order, one entry of part a channel.
  s_red[0][j][x] = sc;
  s_red[1][j][x] = sbr;
  s_red[2][j][x] = sbi;
  __syncthreads();
  if (j < 3 && active) {
    float v = 0.f;
#pragma unroll
    for (int m = 0; m < kChunks; ++m) v += s_red[j][m][x];
    p.part[j * channels + c] = v;
  }
}

template <typename T>
cudaError_t launch_bwd(const LruBwdArgs& a, float* dsum, cudaStream_t st) {
  const long long blocks = (a.B * a.W + kBwdLanes - 1) / kBwdLanes;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  lru_bwd_kernel<T><<<static_cast<unsigned>(blocks),
                      dim3(kBwdLanes, kChunks), 0, st>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // (3, B, W) -> (3, W): each of dc, db_r, db_i summed over B in order.
  return ckio::ordered_sum(a.part, dsum, 3, a.B, a.W, st);
}

}  // namespace

// a, b: (B,S,W); h0: (B,W) or null; h: (B,S,W). All fp32, contiguous, on
// the stream's device.
extern "C" int ckio_rglru_scan(const float* a, const float* b, const float* h0,
                               float* h, long long B, long long S, long long W,
                               void* stream) {
  if (B < 1 || S < 0 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return static_cast<int>(cudaSuccess);
  LruArgs p{};
  p.a = a; p.b = b; p.h0 = h0; p.out = h; p.B = B; p.S = S; p.W = W;
  return static_cast<int>(
      launch<float, false>(p, static_cast<cudaStream_t>(stream)));
}

// r_pre, i_pre: (B,S,W) fp32 contiguous; xr, gate: (B,S,W) in the compute
// dtype (bf16 when bf16 != 0, else fp32) with (b, t, w) element strides in
// strides[0..2] and strides[3..5]; b_r, b_i, lam: (W) fp32; h0: (B,W) fp32
// or null; y: (B,S,W) contiguous in the compute dtype; hS: (B,W) fp32 or
// null.
extern "C" int ckio_rglru_scan_gated(
    const float* r_pre, const float* i_pre, const void* xr, const void* gate,
    const float* b_r, const float* b_i, const float* lam, const float* h0,
    void* y, float* hS, long long B, long long S, long long W, int bf16,
    const long long* strides, void* stream) {
  if (B < 1 || S < 0 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  LruArgs p{};
  p.a = r_pre; p.b = i_pre; p.xr = xr; p.gate = gate;
  p.b_r = b_r; p.b_i = b_i; p.lam = lam; p.h0 = h0; p.out = y; p.hS = hS;
  p.B = B; p.S = S; p.W = W;
  p.sxr = View3{strides[0], strides[1], strides[2]};
  p.sg = View3{strides[3], strides[4], strides[5]};
  const int V = bf16 ? 8 : 4;
  p.vec_xr = (reinterpret_cast<uintptr_t>(xr) & 15u) == 0 && strides[1] == 1 &&
             strides[0] % V == 0 && strides[2] % V == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? launch<__nv_bfloat16, true>(p, st)
                               : launch<float, true>(p, st));
}

// The gated entry's gradient. gy, xr, gate: (B,S,W) in the compute dtype
// (bf16 when bf16 != 0, else fp32) with their (b, t, w) element strides in
// strides[0..2] (xr), [3..5] (gate) and [6..8] (gy); r_pre, i_pre the
// forward's fp32 inputs as for ckio_rglru_scan_gated. Writes dr_pre, di_pre
// (B,S,W) fp32, dxr, dgate (B,S,W) contiguous in the compute dtype, dsum
// (3, W) fp32 = (dc, db_r, db_i) with c = -8 softplus(lam), and dh0 (B,W)
// when not null. Scratch: hseg B*ceil(S/128)*W floats, part 3*B*W floats.
extern "C" int ckio_rglru_scan_gated_backward(
    const float* r_pre, const float* i_pre, const void* xr, const void* gate,
    const void* gy, const float* b_r, const float* b_i, const float* lam,
    const float* h0, float* dr, float* di, void* dxr, void* dgate, float* dh0,
    float* hseg, float* part, float* dsum, long long B, long long S,
    long long W, int bf16, const long long* strides, void* stream) {
  if (B < 1 || S < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  LruBwdArgs p{};
  p.r_pre = r_pre; p.i_pre = i_pre; p.xr = xr; p.gate = gate; p.gy = gy;
  p.b_r = b_r; p.b_i = b_i; p.lam = lam; p.h0 = h0;
  p.dr = dr; p.di = di; p.dxr = dxr; p.dgate = dgate; p.dh0 = dh0;
  p.hseg = hseg; p.part = part; p.B = B; p.S = S; p.W = W;
  p.sxr = View3{strides[0], strides[1], strides[2]};
  p.sg = View3{strides[3], strides[4], strides[5]};
  p.sgy = View3{strides[6], strides[7], strides[8]};
  const int V = bf16 ? 8 : 4;
  p.vec_xr = (reinterpret_cast<uintptr_t>(xr) & 15u) == 0 && strides[1] == 1 &&
             strides[0] % V == 0 && strides[2] % V == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? launch_bwd<__nv_bfloat16>(p, dsum, st)
                               : launch_bwd<float>(p, dsum, st));
}
