// Flash-attention forward on an NVIDIA Hopper card (sm_90a).
//
// Four kernels behind one plain C entry point, and the training forward
// behind a second (loaded through ctypes by
// repro_torch/kernels/flash_attention.py). The launcher picks a path from
// the shapes and the dtype alone, enqueues on the stream it is given,
// allocates nothing (the wrapper passes the decode path's fp32 scratch),
// and returns the first cudaGetLastError() that is not a success, so that
// a refused launch is reported at the call.
//
// Replaces flash_attention_bhsd (src/repro/kernels/flash_attention.py,
//   _fa_kernel). q (B,H,Sq,hd), k/v (B,K,Sk,hd), any element strides;
//   query head h reads kv head h / (H/K). Scores are q.k * hd^-0.5 in fp32
//   (on the decode path, with softcap > 0, then cap * tanh(s / cap), the
//   reference's _sdpa, before the mask and the running max; the combine
//   step merges the capped partials unchanged, and the prefill paths,
//   which no capped caller reaches, refuse a cap);
//   a key is kept when kpos <= qpos (causal, positions end-aligned: qpos =
//   iq + Sk - Sq) and qpos - kpos < window (window > 0); masked scores are
//   -2e38. The running max, denominator and accumulator are fp32; a row
//   with no kept key gives 0 (the denominator is clamped to 1e-30, as in
//   the Pallas kernel); the output is written in q's type. fp32 and bf16,
//   hd in {16, 32, 64, 128, 256}, any Sq and Sk (ragged tails are masked).
//
// Paths, in the order the launcher tries them:
//
// 1. Split-key decode (decode_kernel, then combine_kernel) when the query
//    rows of one kv head fit one block: Sq <= 16 / min(G, 16), G = H/K
//    (every Sq = 1 call). Bound: bytes — each key and value of the prefix
//    is read once for G dot products: 2.1 MB for a full 2,048-slot ring at
//    hd 256, 0.63 us at 3.35 TB/s. One block per kv head would leave an
//    MQA ring on 1 SM; here the grid is (splits, K x group chunks, B).
//    The key axis is cut into spans by a plan that depends on (Sk, hd)
//    only (split_plan in flash_attention.py: 32-key tiles, at least 4,096
//    elements of k a span, at most 64 spans), so a row gets the same bits
//    at any B or H. Spans wholly outside the window are not launched. A
//    block (8 warps at hd >= 128, 4 below; room for 4 or 16 rows) walks its
//    span in 32-key tiles staged with 16-byte cp.async copies (an
//    instantiation with scalar loads takes strides that are not unit or not
//    16-byte aligned), the next tile in flight while the current one is
//    scored. Every warp works whatever G is: warp w scores the tile's 32
//    keys (one a lane) over its share of the dims for every row, the shares
//    are summed in warp order, one warp a row keeps the online softmax, and
//    every thread owns one dim of the PV product. A block writes fp32
//    partials (max, denominator, the unnormalised accumulator);
//    combine_kernel merges them in split order, a split whose max is still
//    the -2e38 fill weighing 0. It is launched as a programmatic dependent
//    of the decode grid, so its launch overlaps that grid's run. With one
//    split launched the block writes the output directly. Arithmetic stays
//    fp32 FMA on the CUDA cores for both dtypes: decode is bound by bytes.
//    At these sizes a block's run is a chain of dependent steps (about 3 us
//    at hd 256 with 10 rows, whatever Sk), which is what its time is.
//
// 2. Tensor-core prefill (tc_kernel), bf16, every other call. Bound:
//    operations — 4 * H * hd * (kept (q, k) pairs) FLOPs over 989 TFLOP/s
//    (0.026 ms for phi4-mini's 2,048-token causal prefill). FlashAttention-2
//    tiles: a block takes 64 consecutive (position, head) rows of one kv
//    head, so the GQA heads of a position share every staged k/v tile;
//    each of its 4 warps owns 16 rows. K/V tiles of 64 keys (32 at hd 256,
//    where a thread holds 128 fp32 accumulators of its 256-wide rows) sit in
//    XOR-swizzled shared memory, double-buffered with cp.async; Q stays in
//    shared memory. ldmatrix feeds mma.sync.m16n8k16 (bf16 in, fp32
//    accumulate) for S = QK^T and, with P rounded to bf16 in registers, for
//    O += PV; the online softmax stays in registers (ex2.approx of
//    log2e-scaled scores). Tiles outside a block's causal/window band are
//    skipped, a warp skips the tiles outside its own rows' band and masks
//    only the tiles its rows do not keep whole; blocks start from the
//    longest key ranges.
//
// 3. CUDA-core prefill (flash_kernel), fp32, every other call: TF32 would
//    break the 1e-5 fp32 tolerance. One block of 4 warps per (batch, kv
//    head, up to 16 query rows) walks 32-key tiles staged once in shared
//    memory as fp32 (static shared memory while it fits 48 KB, hd <= 128:
//    dynamic tiles cost 12 % there; dynamic at hd 256). Warp w owns rows w,
//    w+4, w+8, w+12; lane j scores key j; the PV product gives each lane
//    hd/32 dims.
//
// Training (ckio_flash_attention_train): tc_kernel with LSE set, at every
// shape, also writes each row's log-sum-exp of its kept scaled scores,
// (m + log2(l)) ln 2 from the running max m and denominator l it already
// keeps (+inf for a row with no kept key), for the backward kernels of
// flash_attention_bwd.cu; bf16, causal with an optional window, hd 64 /
// 128 / 256. The output is the inference entry's, bit for bit.
//
// Every sum is taken in a fixed order (no atomics; the split combine runs
// in split order), so the result is the same on every run.
//
// What it leaves for later: wgmma and TMA for the prefill (mma.sync reaches
// a fraction of the tensor cores' rate), a persistent schedule, warp
// specialisation, and a decode block with a shorter critical path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_tiles.cuh"

namespace {

constexpr int kThreads = 128;                      // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileK = 32;                         // keys per tile: one per lane
constexpr int kMaxRows = 16;                       // query rows per block
constexpr int kRowsPerWarp = kMaxRows / kWarps;    // 4: warp w owns rows w + kWarps*i
constexpr int kMaxSplits = 64;                     // split_plan's cap
constexpr float kNegInf = -2.0e38f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
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
  float softcap;  // > 0: decode_kernel caps the scaled scores (cap tanh(s/cap))
  // Split-key decode: keys a split, the first split launched, the number
  // launched; fp32 partials, (row, split) major: max and denominator, and
  // the hd-long accumulator.
  int span, first_split, ns;
  int q_vec;      // q's dims contiguous and 16-byte aligned
  float* part_ml;
  float* part_acc;
  float* lse;     // tc_kernel<.., LSE>: each row's log-sum-exp, (B, H, Sq)
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

// ============================================================================
// 3. CUDA-core prefill, fp32 (flash_kernel)
// ============================================================================

// Shared memory of one block: the query rows, the key tile (rows padded
// to HD + 1 floats) and the value tile, all fp32. Static while it fits the
// 48 KB static limit (hd <= 128), dynamic beyond it (hd 256: 82,048 B):
// at hd 128, dynamic tiles compiled to 70 registers instead of 96 and ran
// 12 % slower at decode on an H100.
__host__ __device__ constexpr size_t smem_bytes(int hd) {
  return sizeof(float) *
         (static_cast<size_t>(kMaxRows) * hd + kTileK * (hd + 1) + kTileK * hd);
}
__host__ __device__ constexpr bool static_tiles(int hd) {
  return smem_bytes(hd) <= 48 * 1024;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const Params p) {
  constexpr int DPL = HD >= 32 ? HD / 32 : 1;      // output dims per lane
  constexpr bool kStatic = static_tiles(HD);
  __shared__ float q_st[kStatic ? kMaxRows * HD : 1];
  __shared__ float k_st[kStatic ? kTileK * (HD + 1) : 1];
  __shared__ float v_st[kStatic ? kTileK * HD : 1];
  extern __shared__ float smem[];
  float* q_sm = kStatic ? q_st : smem;                        // kMaxRows*HD
  float* k_sm = kStatic ? k_st : q_sm + kMaxRows * HD;        // kTileK*(HD+1)
  float* v_sm = kStatic ? v_st : k_sm + kTileK * (HD + 1);    // kTileK*HD

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

// ============================================================================
// 1. Split-key decode (decode_kernel, combine_kernel)
// ============================================================================

// A decode block: 8 warps at hd >= 128, 4 below, and room for RMAX query
// rows (4 or 16: the launcher takes the smaller that fits).
__host__ __device__ constexpr int decode_threads(int hd) { return hd >= 128 ? 256 : 128; }

template <typename T, int HD, int RMAX>
struct DecodeLayout {
  static constexpr int kThreads = decode_threads(HD);
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kPad = 16 / sizeof(T);   // a row padded by 16 bytes:
  static constexpr int kLd = HD + kPad;         // lanes reading 16 B of 8
                                                // successive rows hit 8 banks
  static constexpr size_t kRowOff = sizeof(long long) * 2 * RMAX;
  static constexpr size_t kQ = sizeof(float) * RMAX * HD;
  static constexpr size_t kTile = sizeof(T) * kTileK * kLd;
  static constexpr size_t kScores = sizeof(float) * kWarps * RMAX * kTileK;
  static constexpr size_t kProbs = sizeof(float) * RMAX * kTileK;
  static constexpr size_t kRowState = sizeof(float) * 4 * RMAX;
  // per-row q and output offsets, q, two stages of a k and a v tile,
  // partial scores, probabilities, per-row alpha / max / denominator /
  // its reciprocal.
  static constexpr size_t kBytes =
      kRowOff + kQ + 4 * kTile + kScores + kProbs + kRowState;
};

// N consecutive elements (16 bytes, or 8 of bf16; aligned to it) as floats.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* src, float (&out)[N]) {
  if constexpr (sizeof(T) == 4) {
    static_assert(N == 4, "fp32 chunk");
    const float4 x = *reinterpret_cast<const float4*>(src);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else {
    static_assert(N == 8 || N == 4, "bf16 chunk");
    if constexpr (N == 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(src);
      const __nv_bfloat162* hv = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(hv[i]);
        out[2 * i] = f.x; out[2 * i + 1] = f.y;
      }
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(src);
      const __nv_bfloat162* hv = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 f = __bfloat1622float2(hv[i]);
        out[2 * i] = f.x; out[2 * i + 1] = f.y;
      }
    }
  }
}

template <typename T, int HD, int RMAX, bool VEC>
__global__ void __launch_bounds__(decode_threads(HD), 1)
decode_kernel(const Params p) {
  using L = DecodeLayout<T, HD, RMAX>;
  constexpr int NW = L::kWarps;
  constexpr int NTH = L::kThreads;
  constexpr int LD = L::kLd;
  constexpr int EPC = 16 / (int)sizeof(T);           // elements a 16-byte chunk
  constexpr int CH = HD / EPC;                       // chunks a row
  constexpr int DW = HD / NW;                        // dims a warp scores
  constexpr int NV = EPC < DW ? EPC : DW;            // elements a lane reads at once
  // PV product: thread t owns dim t % HD of the rows of group t / HD.
  constexpr int NRG = NTH / HD;                      // row groups
  constexpr int RPT = (RMAX + NRG - 1) / NRG;        // rows a thread
  constexpr int RPW = (RMAX + NW - 1) / NW;          // softmax rows a warp

  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* q_off = reinterpret_cast<long long*>(smem_raw);         // [RMAX]
  long long* o_off = q_off + RMAX;                                   // [RMAX]
  float* q_sm = reinterpret_cast<float*>(smem_raw + L::kRowOff);     // [RMAX][HD]
  T* kv_sm = reinterpret_cast<T*>(smem_raw + L::kRowOff + L::kQ);    // [stage][k|v][TK][LD]
  float* sp = reinterpret_cast<float*>(smem_raw + L::kRowOff + L::kQ + 4 * L::kTile);
  float* pp = sp + NW * RMAX * kTileK;                               // [row][TK]
  float* alpha_sm = pp + RMAX * kTileK;                              // [row]
  float* m_sm = alpha_sm + RMAX;
  float* l_sm = m_sm + RMAX;
  float* inv_sm = l_sm + RMAX;

  const T* __restrict__ q = static_cast<const T*>(p.q);
  const T* __restrict__ k = static_cast<const T*>(p.k);
  const T* __restrict__ v = static_cast<const T*>(p.v);

  // The combine grid may launch now; it waits for this grid's partials.
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  const int split = p.first_split + blockIdx.x;
  const long long b = blockIdx.z;
  const int kh = blockIdx.y / p.n_gchunks;
  const int g0 = (blockIdx.y % p.n_gchunks) * p.GB;
  const int gb = min(p.GB, p.G - g0);     // query heads of this block
  const int rows = gb * p.Sq;             // row r: position r / gb,
                                          //        head kh*G + g0 + r % gb
  const int off = p.Sk - p.Sq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // This split's keys that any row may keep (the last row sits at Sk - 1,
  // so the causal mask cuts no split's end).
  int ka = split * p.span;
  const int kb = min(p.Sk, ka + p.span);
  if (p.window > 0) ka = max(ka, off - p.window + 1);
  const int nt = kb > ka ? (kb - ka + kTileK - 1) / kTileK : 0;

  const long long kbase = b * p.ks[0] + kh * p.ks[1];
  const long long vbase = b * p.vs[0] + kh * p.vs[1];
  auto stage = [&](int t, int buf) {
    const int k0 = ka + t * kTileK;
    const int n = min(kTileK, kb - k0);
    T* ks = kv_sm + (2 * buf) * kTileK * LD;
    T* vs = ks + kTileK * LD;
    if constexpr (VEC) {
      for (int e = threadIdx.x; e < kTileK * CH; e += NTH) {
        const int j = e / CH, c = e % CH;
        const bool in = j < n;
        const long long kk = in ? k0 + j : k0;        // zero-filled past n
        cp_async16(ks + j * LD + c * EPC, k + kbase + kk * p.ks[2] + c * EPC, in);
        cp_async16(vs + j * LD + c * EPC, v + vbase + kk * p.vs[2] + c * EPC, in);
      }
    } else {
      for (int e = threadIdx.x; e < kTileK * HD; e += NTH) {
        const int j = e / HD, d = e % HD;
        T kx = from_f<T>(0.f), vx = from_f<T>(0.f);
        if (j < n) {
          const long long kk = k0 + j;
          kx = k[kbase + kk * p.ks[2] + d * p.ks[3]];
          vx = v[vbase + kk * p.vs[2] + d * p.vs[3]];
        }
        ks[j * LD + d] = kx;
        vs[j * LD + d] = vx;
      }
    }
  };

  // The first tile goes out before anything else. Rows past `rows` get
  // p = 0 and alpha = 1, so the PV product runs over all RMAX rows
  // without branches.
  if (nt > 0) {
    stage(0, 0);
    cp_async_commit();
  }
  if (threadIdx.x < RMAX) {
    const int r = threadIdx.x;
    const long long h = kh * p.G + g0 + r % gb;
    const long long iq = r / gb;
    q_off[r] = b * p.qs[0] + h * p.qs[1] + iq * p.qs[2];
    o_off[r] = p.ns == 1 ? b * p.os[0] + h * p.os[1] + iq * p.os[2]
                         : (b * p.H + h) * p.Sq + iq;   // partials' row
    alpha_sm[r] = 1.f;
  }
  for (int e = threadIdx.x; e < RMAX * kTileK; e += NTH) pp[e] = 0.f;
  __syncthreads();

  // q as fp32: 16-byte loads when its dims are contiguous and aligned.
  if (p.q_vec) {
    constexpr int NQ = (RMAX * CH + NTH - 1) / NTH;
    float x[NQ][EPC];
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int e = threadIdx.x + NTH * i, r = e / CH, c = e % CH;
      if (e < RMAX * CH && r < rows) {
        load_vec<T, EPC>(q + q_off[r] + c * EPC, x[i]);
      } else {
#pragma unroll
        for (int u = 0; u < EPC; ++u) x[i][u] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int e = threadIdx.x + NTH * i;
      if (e < RMAX * CH) {
        float* dst = q_sm + (e / CH) * HD + (e % CH) * EPC;
#pragma unroll
        for (int u = 0; u < EPC; u += 4)
          *reinterpret_cast<float4*>(dst + u) =
              make_float4(x[i][u], x[i][u + 1], x[i][u + 2], x[i][u + 3]);
      }
    }
  } else {
    for (int e = threadIdx.x; e < RMAX * HD; e += NTH) {
      const int r = e / HD, d = e % HD;
      q_sm[e] = r < rows ? to_f(q[q_off[r] + d * p.qs[3]]) : 0.f;
    }
  }

  // Softmax state: warp w keeps rows w + NW*i. PV state: this thread's
  // dim of the rows of its group.
  float m[RPW], l[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  const int pv_d = threadIdx.x % HD;
  const int pv_r0 = threadIdx.x / HD;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  for (int t = 0; t < nt; ++t) {
    const int buf = t & 1;
    if (t + 1 < nt) {
      stage(t + 1, buf ^ 1);               // in flight while t is scored
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks = kv_sm + (2 * buf) * kTileK * LD;
    const T* vs = ks + kTileK * LD;
    const int k0 = ka + t * kTileK;
    const int n = min(kTileK, kb - k0);

    // Partial scores: lane j = key k0 + j, warp w = dims [w*DW, (w+1)*DW).
#pragma unroll
    for (int r0 = 0; r0 < RMAX; r0 += 4) {
      if (r0 >= rows) break;                // uniform across the block
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int d = 0; d < DW; d += NV) {
        float kx[NV];
        load_vec<T, NV>(ks + lane * LD + warp * DW + d, kx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* qr = q_sm + (r0 + i) * HD + warp * DW + d;
#pragma unroll
          for (int e = 0; e < NV; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qr + e);
            s[i] = fmaf(qv.x, kx[e], s[i]);
            s[i] = fmaf(qv.y, kx[e + 1], s[i]);
            s[i] = fmaf(qv.z, kx[e + 2], s[i]);
            s[i] = fmaf(qv.w, kx[e + 3], s[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) sp[(warp * RMAX + r0 + i) * kTileK + lane] = s[i];
    }
    __syncthreads();

    // Online softmax, one warp a row: the warps' partial scores summed in
    // warp order.
    const int kpos = k0 + lane;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + NW * i;
      if (r >= rows) break;                 // uniform across the warp
      const int qpos = r / gb + off;
      float sc = sp[r * kTileK + lane];
#pragma unroll
      for (int w = 1; w < NW; ++w) sc += sp[(w * RMAX + r) * kTileK + lane];
      bool ok = lane < n;
      if (p.causal) ok = ok && kpos <= qpos;
      if (p.window > 0) ok = ok && qpos - kpos < p.window;
      sc *= p.scale;
      if (p.softcap > 0.f) sc = p.softcap * tanhf(sc / p.softcap);
      sc = ok ? sc : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(sc));
      const float pj =
          ok ? expf(sc - (m_new <= kNegInf * 0.5f ? 0.f : m_new)) : 0.f;
      const float alpha = m[i] <= kNegInf * 0.5f ? 0.f : expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(pj);
      m[i] = m_new;
      pp[r * kTileK + lane] = pj;
      if (lane == 0) alpha_sm[r] = alpha;
    }
    __syncthreads();

    // PV over all RMAX rows: the rows past n hold zeros (zero-filled or
    // stored), with p = 0.
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = pv_r0 + NRG * i;
      acc[i] *= r < RMAX ? alpha_sm[r] : 1.f;
    }
#pragma unroll 4
    for (int j = 0; j < kTileK; j += 4) {
      float vx[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) vx[jj] = to_f(vs[(j + jj) * LD + pv_d]);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = pv_r0 + NRG * i;
        if (NRG * RPT == RMAX || r < RMAX) {
          const float4 p4 = *reinterpret_cast<const float4*>(pp + r * kTileK + j);
          acc[i] = fmaf(p4.x, vx[0], acc[i]);
          acc[i] = fmaf(p4.y, vx[1], acc[i]);
          acc[i] = fmaf(p4.z, vx[2], acc[i]);
          acc[i] = fmaf(p4.w, vx[3], acc[i]);
        }
      }
    }
    __syncthreads();                        // buffer `buf` is free again
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + NW * i;
      if (r < rows) {
        m_sm[r] = m[i];
        l_sm[r] = l[i];
        inv_sm[r] = 1.f / fmaxf(l[i], 1e-30f);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = pv_r0 + NRG * i;
    if (r >= rows) continue;
    if (p.ns == 1) {
      T* out = static_cast<T*>(p.o) + o_off[r];
      out[pv_d * p.os[3]] = from_f<T>(acc[i] * inv_sm[r]);
    } else {
      const long long slot = o_off[r] * p.ns + blockIdx.x;
      p.part_acc[slot * HD + pv_d] = acc[i];
      if (pv_d == 0) {
        p.part_ml[2 * slot] = m_sm[r];
        p.part_ml[2 * slot + 1] = l_sm[r];
      }
    }
  }
}

// One block of hd threads a row (b, h, iq): the splits' partials merged in
// split order. Every load is issued before the first sum.
template <typename T>
__global__ void __launch_bounds__(256)
combine_kernel(const Params p) {
  __shared__ float m_sm[kMaxSplits], l_sm[kMaxSplits], w_sm[kMaxSplits];
  const int hd = blockDim.x;
  const int ns = p.ns;
  const long long row = blockIdx.x;       // (b*H + h)*Sq + iq
  const long long iq = row % p.Sq;
  const long long h = (row / p.Sq) % p.H;
  const long long b = row / (static_cast<long long>(p.Sq) * p.H);
  const float* ml = p.part_ml + row * ns * 2;
  const float* pa = p.part_acc + row * ns * hd + threadIdx.x;
  // Launched early (programmatic dependent launch): wait until the decode
  // grid has finished and its partials are visible.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  float x[kMaxSplits];
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) x[s] = s < ns ? pa[s * hd] : 0.f;
  for (int s = threadIdx.x; s < ns; s += hd) {
    m_sm[s] = ml[2 * s];
    l_sm[s] = ml[2 * s + 1];
  }
  __syncthreads();
  float mx = kNegInf;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s)
    if (s < ns) mx = fmaxf(mx, m_sm[s]);
  for (int s = threadIdx.x; s < ns; s += hd)
    w_sm[s] = m_sm[s] <= kNegInf * 0.5f ? 0.f : expf(m_sm[s] - mx);
  __syncthreads();
  float den = 0.f, acc = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    if (s < ns) {
      den = fmaf(w_sm[s], l_sm[s], den);
      acc = fmaf(w_sm[s], x[s], acc);
    }
  }
  T* out = static_cast<T*>(p.o) + b * p.os[0] + h * p.os[1] + iq * p.os[2];
  out[threadIdx.x * p.os[3]] = from_f<T>(acc / fmaxf(den, 1e-30f));
}

// ============================================================================
// 2. Tensor-core prefill, bf16 (tc_kernel)
// ============================================================================

template <int HD>
struct TcLayout {
  static constexpr int kRows = 16 * kWarps;           // query rows a block
  static constexpr int kBK = HD >= 256 ? 32 : 64;     // keys a tile
  static constexpr size_t kQ = 2 * kRows * HD;
  static constexpr size_t kTile = 2 * kBK * HD;
  static constexpr size_t kBytes = kQ + 4 * kTile;    // q, 2 stages of k and v
};

template <int HD, bool VEC, bool LSE>
__global__ void __launch_bounds__(kThreads, 1)
tc_kernel(const Params p) {
  using L = TcLayout<HD>;
  constexpr int ROWS = L::kRows;
  constexpr int BK = L::kBK;
  constexpr int C = HD / 8;                 // 16-byte chunks a row
  constexpr int NT = BK / 8;                // n-tiles of a score tile
  constexpr int NO = HD / 8;                // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* q_sm = smem_raw;
  unsigned char* kv_sm = smem_raw + L::kQ;  // stage s: k at 2s, v at 2s + 1

  const __nv_bfloat16* __restrict__ q = static_cast<const __nv_bfloat16*>(p.q);
  const __nv_bfloat16* __restrict__ k = static_cast<const __nv_bfloat16*>(p.k);
  const __nv_bfloat16* __restrict__ v = static_cast<const __nv_bfloat16*>(p.v);
  __nv_bfloat16* __restrict__ o = static_cast<__nv_bfloat16*>(p.o);

  // Rows of a kv head: f = iq * G + g. The last chunks (the longest key
  // ranges under a causal mask) are launched first.
  const int chunk = gridDim.x - 1 - blockIdx.x;
  const int kh = blockIdx.y;
  const long long b = blockIdx.z;
  const int F = p.Sq * p.G;
  const int f0 = chunk * ROWS;
  const int nrows = min(ROWS, F - f0);
  const int off = p.Sk - p.Sq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, tq = lane % 4;   // fragment row and column pair
  const int wr0 = 16 * warp;                // the warp's first row

  const long long qbase = b * p.qs[0] + static_cast<long long>(kh) * p.G * p.qs[1];
  const long long kbase = b * p.ks[0] + kh * p.ks[1];
  const long long vbase = b * p.vs[0] + kh * p.vs[1];

  // The block's band of keys, and each warp's.
  auto band = [&](int r_lo, int r_hi, int& kb0, int& kb1) {
    const int lo = (f0 + r_lo) / p.G + off, hi = (f0 + r_hi) / p.G + off;
    kb0 = p.window > 0 ? max(0, lo - p.window + 1) : 0;
    kb1 = p.causal ? min(p.Sk, hi + 1) : p.Sk;
  };
  int k_begin, k_end, w_begin = 0, w_end = 0;
  band(0, nrows - 1, k_begin, k_end);
  const int w_last = min(nrows, wr0 + 16) - 1;   // the warp's last valid row
  if (wr0 < nrows) band(wr0, w_last, w_begin, w_end);
  const int t0 = k_begin / BK;
  const int t1 = k_end > k_begin ? (k_end + BK - 1) / BK : t0;

  int qpos[2];
  float m_r[2], l_r[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = wr0 + gr + 8 * hr;
    qpos[hr] = r < nrows ? (f0 + r) / p.G + off : -(1 << 30);
    m_r[hr] = kNegInf;
    l_r[hr] = 0.f;
  }
  float o_acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[j][e] = 0.f;
  const float sl2 = p.scale * kLog2e;

  auto stage_kv = [&](int t, int s) {
    const int k0 = t * BK;
    const int n = min(BK, p.Sk - k0);
    tc_stage<HD, BK, VEC, kThreads>(kv_sm + (2 * s) * L::kTile, k, p.ks[3], n,
                          [&](int j) { return kbase + (k0 + j) * p.ks[2]; });
    tc_stage<HD, BK, VEC, kThreads>(kv_sm + (2 * s + 1) * L::kTile, v, p.vs[3], n,
                          [&](int j) { return vbase + (k0 + j) * p.vs[2]; });
  };

  if (t1 > t0) {
    tc_stage<HD, ROWS, VEC, kThreads>(q_sm, q, p.qs[3], nrows, [&](int r) {
      const int f = f0 + r;
      return qbase + static_cast<long long>(f % p.G) * p.qs[1] +
             static_cast<long long>(f / p.G) * p.qs[2];
    });
    stage_kv(t0, 0);
    cp_async_commit();
  }
  const unsigned q_addr = smem_u32(q_sm);
  const int li = lane / 8, lr = lane % 8;   // ldmatrix: matrix, row in it
  for (int t = t0; t < t1; ++t) {
    const int s = (t - t0) & 1;
    if (t + 1 < t1) {
      stage_kv(t + 1, s ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = t * BK;
    if (k0 < w_end && k0 + BK > w_begin) {   // uniform across the warp
      const unsigned k_addr = smem_u32(kv_sm + (2 * s) * L::kTile);
      const unsigned v_addr = smem_u32(kv_sm + (2 * s + 1) * L::kTile);

      // S = Q K^T: 16 rows x BK keys a warp.
      float sacc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        unsigned a[4];
        ldsm_x4(a, q_addr + swz<C>(wr0 + lane % 16, 2 * kk + lane / 16));
#pragma unroll
        for (int nn = 0; nn < NT / 2; ++nn) {
          unsigned bk[4];
          ldsm_x4(bk, k_addr + swz<C>(16 * nn + 8 * (li / 2) + lr, 2 * kk + li % 2));
          mma_bf16(sacc[2 * nn], a, bk[0], bk[1]);
          mma_bf16(sacc[2 * nn + 1], a, bk[2], bk[3]);
        }
      }

      // Mask, then the online softmax of rows gr and gr + 8 (a quad of
      // lanes holds a row's columns). A tile that every row of the warp
      // keeps whole needs no mask.
      const bool whole = k0 + BK <= p.Sk &&
                         (!p.causal || k0 + BK - 1 <= (f0 + wr0) / p.G + off) &&
                         (p.window <= 0 || (f0 + w_last) / p.G + off - k0 < p.window);
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e / 2;
          float x = sacc[j][e] * sl2;
          if (!whole) {
            const int kpos = k0 + 8 * j + 2 * tq + (e & 1);
            bool ok = kpos < p.Sk;
            if (p.causal) ok = ok && kpos <= qpos[hr];
            if (p.window > 0) ok = ok && qpos[hr] - kpos < p.window;
            x = ok ? x : kNegInf;
          }
          sacc[j][e] = x;
          mx[hr] = fmaxf(mx[hr], x);
        }
      float base[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(kFull, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(kFull, mx[hr], 2));
        const float alpha = m_r[hr] <= kNegInf * 0.5f ? 0.f : ex2(m_r[hr] - mx[hr]);
        base[hr] = mx[hr] <= kNegInf * 0.5f ? 0.f : mx[hr];
        m_r[hr] = mx[hr];
        l_r[hr] *= alpha;
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          o_acc[j][2 * hr] *= alpha;
          o_acc[j][2 * hr + 1] *= alpha;
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e / 2;
          const float x = sacc[j][e];
          const float pe = x <= kNegInf * 0.5f ? 0.f : ex2(x - base[hr]);
          l_r[hr] += pe;
          sacc[j][e] = pe;
        }

      // O += P V, P rounded to bf16 in the A-fragment layout.
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        unsigned a[4];
        a[0] = pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]);
        a[1] = pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]);
        a[2] = pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]);
        a[3] = pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3]);
#pragma unroll
        for (int nn = 0; nn < NO / 2; ++nn) {
          unsigned bv[4];
          ldsm_x4_t(bv, v_addr + swz<C>(16 * kk + 8 * (li % 2) + lr, 2 * nn + li / 2));
          mma_bf16(o_acc[2 * nn], a, bv[0], bv[1]);
          mma_bf16(o_acc[2 * nn + 1], a, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();                         // stage s is free again
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float den = l_r[hr];
    den += __shfl_xor_sync(kFull, den, 1);
    den += __shfl_xor_sync(kFull, den, 2);
    const float inv = 1.f / fmaxf(den, 1e-30f);
    const int r = wr0 + gr + 8 * hr;
    if (r >= nrows) continue;
    const int f = f0 + r;
    const long long h = static_cast<long long>(kh) * p.G + f % p.G;
    const long long iq = f / p.G;
    if constexpr (LSE) {
      // log(sum_j exp(s_j)) = (m + log2(den)) ln 2, m the log2e-scaled
      // running max; +inf for a row with no kept key (P = 0 everywhere).
      if (tq == 0)
        p.lse[(b * p.H + h) * p.Sq + iq] =
            den > 0.f ? (m_r[hr] + log2f(den)) * kLn2 : __int_as_float(0x7f800000);
    }
    __nv_bfloat16* out = o + b * p.os[0] + h * p.os[1] + iq * p.os[2];
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int d = 8 * j + 2 * tq;
      out[d * p.os[3]] = __float2bfloat16(o_acc[j][2 * hr] * inv);
      out[(d + 1) * p.os[3]] = __float2bfloat16(o_acc[j][2 * hr + 1] * inv);
    }
  }
}

// ============================================================================
// Launchers
// ============================================================================

// Once per instantiation (a thread-safe static), before its first launch:
// dynamic shared memory past 48 KB has to be asked for.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int HD>
cudaError_t launch_prefill_fp32(const Params& p, dim3 grid, cudaStream_t st) {
  constexpr size_t smem = static_tiles(HD) ? 0 : smem_bytes(HD);
  static const cudaError_t attr = allow_smem(flash_kernel<float, HD>, smem);
  if (attr != cudaSuccess) return attr;
  flash_kernel<float, HD><<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename T, int HD, int RMAX, bool VEC>
cudaError_t launch_decode_rows(const Params& p, dim3 grid, cudaStream_t st) {
  using L = DecodeLayout<T, HD, RMAX>;
  static const cudaError_t attr = allow_smem(decode_kernel<T, HD, RMAX, VEC>, L::kBytes);
  if (attr != cudaSuccess) return attr;
  decode_kernel<T, HD, RMAX, VEC><<<grid, L::kThreads, L::kBytes, st>>>(p);
  return cudaGetLastError();
}

template <typename T, int HD, bool VEC>
cudaError_t launch_decode(const Params& p, dim3 grid, long long rows, cudaStream_t st) {
  cudaError_t err = p.GB * p.Sq <= 4 ? launch_decode_rows<T, HD, 4, VEC>(p, grid, st)
                                     : launch_decode_rows<T, HD, kMaxRows, VEC>(p, grid, st);
  if (err != cudaSuccess || p.ns == 1) return err;
  // Launched as a programmatic dependent of the decode grid, so that its
  // launch overlaps the decode grid's run.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows));
  cfg.blockDim = dim3(HD);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, combine_kernel<T>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int HD, bool VEC, bool LSE = false>
cudaError_t launch_tc(const Params& p, dim3 grid, cudaStream_t st) {
  constexpr int rows = TcLayout<HD>::kRows;
  grid.x = static_cast<unsigned>((static_cast<long long>(p.Sq) * p.G + rows - 1) / rows);
  constexpr size_t smem = TcLayout<HD>::kBytes;
  static const cudaError_t attr = allow_smem(tc_kernel<HD, VEC, LSE>, smem);
  if (attr != cudaSuccess) return attr;
  tc_kernel<HD, VEC, LSE><<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch(const Params& p, int dtype, int path, bool vec, dim3 grid,
                     long long rows, cudaStream_t st) {
  if (path == 0) {                          // split-key decode
    if (dtype == 0)
      return vec ? launch_decode<float, HD, true>(p, grid, rows, st)
                 : launch_decode<float, HD, false>(p, grid, rows, st);
    return vec ? launch_decode<__nv_bfloat16, HD, true>(p, grid, rows, st)
               : launch_decode<__nv_bfloat16, HD, false>(p, grid, rows, st);
  }
  if (path == 1)                            // tensor-core prefill, bf16
    return vec ? launch_tc<HD, true>(p, grid, st) : launch_tc<HD, false>(p, grid, st);
  return launch_prefill_fp32<HD>(p, grid, st);
}

// 16-byte staging needs a unit dim stride and every other stride that is
// used (a dim of size > 1) a multiple of 16 bytes, from a 16-byte aligned base.
bool vec_ok(const void* ptr, const long long* s, const long long* sizes, int elem) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0 || s[3] != 1) return false;
  for (int i = 0; i < 3; ++i)
    if (sizes[i] > 1 && (s[i] * elem) % 16 != 0) return false;
  return true;
}

}  // namespace

// dims (host memory): B, H, K, Sq, Sk, then the element strides (batch,
// head, position, dim) of q, k, v and out. dtype: 0 = float32, 1 = bfloat16.
// span / n_splits: the decode plan (flash_attention.split_plan); scratch:
// B*H*Sq*n_splits*(hd + 2) floats, used by the decode path when it
// launches more than one split (may be null otherwise).
extern "C" int ckio_flash_attention(const void* q, const void* k, const void* v,
                                    void* out, const long long* dims, int dtype,
                                    int hd, int causal, int window, double scale,
                                    double softcap, int span, int n_splits,
                                    float* scratch, void* stream) {
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
  if (B < 1 || p.K < 1 || p.H % p.K != 0 || p.Sq < 1 || p.Sk < 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  p.G = p.H / p.K;
  p.GB = p.G < kMaxRows ? p.G : kMaxRows;
  p.BQ = kMaxRows / p.GB;
  p.n_gchunks = (p.G + p.GB - 1) / p.GB;
  p.causal = causal;
  p.window = window;
  p.scale = static_cast<float>(scale);
  p.softcap = static_cast<float>(softcap);
  p.span = span;
  p.first_split = 0;
  p.ns = 1;
  p.part_ml = nullptr;
  p.part_acc = nullptr;
  p.lse = nullptr;
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int elem = dtype == 0 ? 4 : 2;
  const long long qsz[3] = {B, p.H, p.Sq}, ksz[3] = {B, p.K, p.Sk};
  const bool kv_vec = vec_ok(k, p.ks, ksz, elem) && vec_ok(v, p.vs, ksz, elem);
  p.q_vec = vec_ok(q, p.qs, qsz, elem);
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  int path;
  dim3 grid;
  long long rows = B * p.H * static_cast<long long>(p.Sq);
  if (p.Sq <= p.BQ) {
    // Split-key decode: the launched splits are those that meet the band
    // of keys any row keeps (end-aligned: the last row is at Sk - 1).
    path = 0;
    if (span < 1 || n_splits < 1 || n_splits > kMaxSplits)
      return static_cast<int>(cudaErrorInvalidValue);
    const int off = p.Sk - p.Sq;
    const int k_begin = window > 0 ? (off - window + 1 > 0 ? off - window + 1 : 0) : 0;
    const int k_end = p.Sk;
    int last = 0;
    if (k_end > k_begin) {
      p.first_split = k_begin / span;
      last = (k_end - 1) / span;
    }
    p.ns = last - p.first_split + 1;
    if (last >= n_splits) return static_cast<int>(cudaErrorInvalidValue);
    if (p.ns > 1) {
      if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      p.part_ml = scratch;
      p.part_acc = scratch + 2 * rows * p.ns;
    }
    const long long gy = static_cast<long long>(p.K) * p.n_gchunks;
    if (gy > 65535 || rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    grid = dim3(static_cast<unsigned>(p.ns), static_cast<unsigned>(gy),
                static_cast<unsigned>(B));
    return static_cast<int>(
        hd == 16    ? dispatch<16>(p, dtype, path, kv_vec, grid, rows, st)
        : hd == 32  ? dispatch<32>(p, dtype, path, kv_vec, grid, rows, st)
        : hd == 64  ? dispatch<64>(p, dtype, path, kv_vec, grid, rows, st)
        : hd == 128 ? dispatch<128>(p, dtype, path, kv_vec, grid, rows, st)
        : hd == 256 ? dispatch<256>(p, dtype, path, kv_vec, grid, rows, st)
                    : cudaErrorInvalidValue);
  }
  // The prefill paths compute no softcap: no capped caller reaches them.
  if (softcap > 0) return static_cast<int>(cudaErrorInvalidValue);
  bool vec = false;
  if (dtype == 1) {
    // Tensor-core prefill: 64 (position, head) rows of a kv head a block
    // (grid.x is set by launch_tc).
    path = 1;
    vec = kv_vec && p.q_vec;
    if (p.K > 65535 || rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    grid = dim3(1, static_cast<unsigned>(p.K), static_cast<unsigned>(B));
  } else {
    path = 2;
    const long long gy = static_cast<long long>(p.K) * p.n_gchunks;
    if (gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
    grid = dim3(static_cast<unsigned>((p.Sq + p.BQ - 1) / p.BQ),
                static_cast<unsigned>(gy), static_cast<unsigned>(B));
  }
  return static_cast<int>(
      hd == 16    ? dispatch<16>(p, dtype, path, vec, grid, rows, st)
      : hd == 32  ? dispatch<32>(p, dtype, path, vec, grid, rows, st)
      : hd == 64  ? dispatch<64>(p, dtype, path, vec, grid, rows, st)
      : hd == 128 ? dispatch<128>(p, dtype, path, vec, grid, rows, st)
      : hd == 256 ? dispatch<256>(p, dtype, path, vec, grid, rows, st)
                  : cudaErrorInvalidValue);
}

// The training forward: tc_kernel writing each row's log-sum-exp beside
// the output, for the backward (flash_attention_bwd.cu). bf16, causal with
// an optional window, hd 64 / 128 / 256, any Sq >= 1: every shape takes the
// tensor-core path, since the backward needs the lse of every row. dims as
// ckio_flash_attention's; lse: B*H*Sq floats, row (b, h, iq) at
// (b*H + h)*Sq + iq.
extern "C" int ckio_flash_attention_train(const void* q, const void* k, const void* v,
                                          void* out, float* lse, const long long* dims,
                                          int hd, int window, double scale,
                                          void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = out;
  p.lse = lse;
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
  if (B < 1 || B > 65535 || p.K < 1 || p.K > 65535 || p.H % p.K != 0 || p.Sq < 1 ||
      p.Sk < 0 || window < 0 || B * p.H * static_cast<long long>(p.Sq) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  p.G = p.H / p.K;
  p.causal = 1;
  p.window = window;
  p.scale = static_cast<float>(scale);
  const long long qsz[3] = {B, p.H, p.Sq}, ksz[3] = {B, p.K, p.Sk};
  const bool vec = vec_ok(q, p.qs, qsz, 2) && vec_ok(k, p.ks, ksz, 2) &&
                   vec_ok(v, p.vs, ksz, 2);
  const dim3 grid(1, static_cast<unsigned>(p.K), static_cast<unsigned>(B));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      hd == 64    ? (vec ? launch_tc<64, true, true>(p, grid, st)
                         : launch_tc<64, false, true>(p, grid, st))
      : hd == 128 ? (vec ? launch_tc<128, true, true>(p, grid, st)
                         : launch_tc<128, false, true>(p, grid, st))
      : hd == 256 ? (vec ? launch_tc<256, true, true>(p, grid, st)
                         : launch_tc<256, false, true>(p, grid, st))
                  : cudaErrorInvalidValue);
}
