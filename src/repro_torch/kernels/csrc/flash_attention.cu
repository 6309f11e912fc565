// Flash-attention forward on an NVIDIA Hopper card (sm_90a).
//
// One kernel with a plain C interface (loaded through ctypes by
// repro_torch/kernels/flash_attention.py). The launcher enqueues on the
// stream it is given, allocates nothing, and returns cudaGetLastError() so
// that a refused launch is reported at the call.
//
// flash_kernel — replaces flash_attention_bhsd
//   (src/repro/kernels/flash_attention.py, _fa_kernel). q (B,H,Sq,hd),
//   k/v (B,K,Sk,hd), any element strides; query head h reads kv head
//   h / (H/K). Scores are q.k * hd^-0.5 in fp32; a key is kept when
//   kpos <= qpos (causal, positions end-aligned: qpos = iq + Sk - Sq) and
//   qpos - kpos < window (window > 0); masked scores are -2e38. The running
//   max, denominator and accumulator are fp32; a row with no kept key gives
//   0 (the denominator is clamped to 1e-30, as in the Pallas kernel); the
//   output is written in q's type. fp32 and bf16, hd in {16, 32, 64, 128}.
//   Any Sq and Sk: the ragged tail tile is masked, so decode (Sq = 1,
//   Sk = pos + 1) needs no padding.
//
//   Bound: at decode (Sq = 1) bytes — every key and value of the prefix is
//   read once and used for G = H/K dot products, so the floor is the q, k,
//   v and output bytes / 3.35 TB/s. At prefill (Sq = Sk = 2048) operations —
//   4 * H * hd * (the kept (q, k) pairs) FLOPs / 989 TFLOP/s.
//
//   Design: one block of 4 warps per (batch, kv head, group of query
//   heads, tile of query positions) walks the key axis in a loop, 32 keys
//   a tile. The tile's keys and values are staged once in shared memory (as
//   fp32) and serve every query row of the block — the G heads of the GQA
//   group times the block's positions, at most 16 rows — which the Pallas
//   version gets from its k/v index maps. Warp w owns rows w, w+4, w+8 and
//   w+12 (round-robin, so a decode block of G = 3 rows keeps 3 warps busy
//   rather than one) and keeps their online softmax in registers: lane j scores key j of the
//   tile (the key tile is padded to a stride of hd+1 floats so the 32 lanes
//   hit 32 banks), the max and the sum are butterfly reductions, and for the
//   PV product each lane owns hd/32 output dimensions. Tiles wholly outside
//   the causal/window band of the block are skipped. Every sum is taken in
//   a fixed order (no atomics, no split over the key axis), so the result
//   is the same on every run.
//
//   What it leaves for later: the products run on the CUDA cores in fp32,
//   not on the tensor cores (wgmma), with no TMA pipelining; and at decode
//   with B = 1 it fills only K blocks (8 of the 132 SMs for phi4-mini): a
//   split over the key axis with a fixed-order combine would fill the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;                      // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileK = 32;                         // keys per tile: one per lane
constexpr int kMaxRows = 16;                       // query rows per block
constexpr int kRowsPerWarp = kMaxRows / kWarps;    // 4: warp w owns rows w + kWarps*i
constexpr float kNegInf = -2.0e38f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qs[4], ks[4], vs[4], os[4];  // element strides: batch, head, position, dim
  int H, K, Sq, Sk;
  int G;          // query heads per kv head
  int GB;         // query heads of one group handled by one block
  int BQ;         // query positions per block
  int n_gchunks;  // blocks per group: ceil(G / GB)
  int causal, window;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Butterfly reductions: every lane ends with the same value (each step adds
// the same two partials in either order), in the same order on every run.
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const Params p) {
  constexpr int DPL = HD >= 32 ? HD / 32 : 1;      // output dims per lane
  __shared__ float q_sm[kMaxRows * HD];
  __shared__ float k_sm[kTileK * (HD + 1)];
  __shared__ float v_sm[kTileK * HD];

  const T* __restrict__ q = static_cast<const T*>(p.q);
  const T* __restrict__ k = static_cast<const T*>(p.k);
  const T* __restrict__ v = static_cast<const T*>(p.v);
  T* __restrict__ o = static_cast<T*>(p.o);

  const long long b = blockIdx.z;
  const int kh = blockIdx.y / p.n_gchunks;
  const int g0 = (blockIdx.y % p.n_gchunks) * p.GB;
  const int iq0 = blockIdx.x * p.BQ;
  const int gb = min(p.GB, p.G - g0);     // query heads of this block
  const int bq = min(p.BQ, p.Sq - iq0);   // query positions of this block
  const int rows = gb * bq;               // row r: position iq0 + r / gb,
                                          //        head kh*G + g0 + r % gb
  const int off = p.Sk - p.Sq;            // end-aligned positions

  for (int e = threadIdx.x; e < kMaxRows * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    float x = 0.f;
    if (r < rows) {
      const long long h = kh * p.G + g0 + r % gb;
      const long long iq = iq0 + r / gb;
      x = to_f(q[b * p.qs[0] + h * p.qs[1] + iq * p.qs[2] + d * p.qs[3]]);
    }
    q_sm[e] = x;
  }

  // Keys any row of the block may keep.
  const int qpos_lo = iq0 + off;
  const int qpos_hi = iq0 + bq - 1 + off;
  int k_begin = 0, k_end = p.Sk;
  if (p.causal) k_end = min(p.Sk, qpos_hi + 1);
  if (p.window > 0) k_begin = max(0, qpos_lo - p.window + 1);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
  int qpos[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    qpos[i] = iq0 + (warp + kWarps * i) / gb + off;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) acc[i][dd] = 0.f;
  }

  const long long kb = b * p.ks[0] + kh * p.ks[1];
  const long long vb = b * p.vs[0] + kh * p.vs[1];
  for (int k0 = k_begin; k0 < k_end; k0 += kTileK) {
    const int n = min(kTileK, k_end - k0);
    __syncthreads();                      // the previous tile is consumed
    for (int e = threadIdx.x; e < kTileK * HD; e += kThreads) {
      const int j = e / HD, d = e % HD;
      float kx = 0.f, vx = 0.f;
      if (j < n) {
        const long long kk = k0 + j;
        kx = to_f(k[kb + kk * p.ks[2] + d * p.ks[3]]);
        vx = to_f(v[vb + kk * p.vs[2] + d * p.vs[3]]);
      }
      k_sm[j * (HD + 1) + d] = kx;
      v_sm[j * HD + d] = vx;
    }
    __syncthreads();

    // Lane j scores key k0 + j against each of the warp's rows.
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float kd = k_sm[lane * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        s[i] = fmaf(q_sm[(warp + kWarps * i) * HD + d], kd, s[i]);
    }

    const int kpos = k0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      if (warp + kWarps * i >= rows) break;   // uniform across the warp
      bool ok = lane < n;
      if (p.causal) ok = ok && kpos <= qpos[i];
      if (p.window > 0) ok = ok && qpos[i] - kpos < p.window;
      const float sc = ok ? s[i] * p.scale : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(sc));
      // Guards of the Pallas kernel: a row with nothing kept yet keeps a
      // finite exponent and contributes nothing.
      const float pj =
          ok ? expf(sc - (m_new <= kNegInf * 0.5f ? 0.f : m_new)) : 0.f;
      const float alpha = m[i] <= kNegInf * 0.5f ? 0.f : expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(pj);
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) acc[i][dd] *= alpha;
      for (int j = 0; j < n; ++j) {
        const float pjj = __shfl_sync(kFull, pj, j);
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) {
          const int d = lane + 32 * dd;
          if (HD >= 32 || d < HD) acc[i][dd] = fmaf(pjj, v_sm[j * HD + d], acc[i][dd]);
        }
      }
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    if (r >= rows) break;
    const long long h = kh * p.G + g0 + r % gb;
    const long long iq = iq0 + r / gb;
    const float denom = fmaxf(l[i], 1e-30f);
    T* out = o + b * p.os[0] + h * p.os[1] + iq * p.os[2];
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) {
      const int d = lane + 32 * dd;
      if (HD >= 32 || d < HD) out[d * p.os[3]] = from_f<T>(acc[i][dd] / denom);
    }
  }
}

template <typename T>
cudaError_t launch(const Params& p, int hd, dim3 grid, cudaStream_t st) {
  switch (hd) {
    case 16: flash_kernel<T, 16><<<grid, kThreads, 0, st>>>(p); break;
    case 32: flash_kernel<T, 32><<<grid, kThreads, 0, st>>>(p); break;
    case 64: flash_kernel<T, 64><<<grid, kThreads, 0, st>>>(p); break;
    case 128: flash_kernel<T, 128><<<grid, kThreads, 0, st>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dims (host memory): B, H, K, Sq, Sk, then the element strides (batch,
// head, position, dim) of q, k, v and out. dtype: 0 = float32, 1 = bfloat16.
extern "C" int ckio_flash_attention(const void* q, const void* k, const void* v,
                                    void* out, const long long* dims, int dtype,
                                    int hd, int causal, int window, double scale,
                                    void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = out;
  const long long B = dims[0];
  p.H = static_cast<int>(dims[1]);
  p.K = static_cast<int>(dims[2]);
  p.Sq = static_cast<int>(dims[3]);
  p.Sk = static_cast<int>(dims[4]);
  for (int i = 0; i < 4; ++i) {
    p.qs[i] = dims[5 + i];
    p.ks[i] = dims[9 + i];
    p.vs[i] = dims[13 + i];
    p.os[i] = dims[17 + i];
  }
  if (B < 1 || p.K < 1 || p.H % p.K != 0 || p.Sq < 1 || p.Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  p.G = p.H / p.K;
  p.GB = p.G < kMaxRows ? p.G : kMaxRows;
  p.BQ = kMaxRows / p.GB;
  p.n_gchunks = (p.G + p.GB - 1) / p.GB;
  p.causal = causal;
  p.window = window;
  p.scale = static_cast<float>(scale);
  const long long gy = static_cast<long long>(p.K) * p.n_gchunks;
  if (B > 65535 || gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((p.Sq + p.BQ - 1) / p.BQ),
                  static_cast<unsigned>(gy), static_cast<unsigned>(B));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0   ? launch<float>(p, hd, grid, st)
                          : dtype == 1 ? launch<__nv_bfloat16>(p, hd, grid, st)
                                       : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
