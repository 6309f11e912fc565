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
