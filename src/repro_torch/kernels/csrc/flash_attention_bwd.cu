// Flash-attention backward on an NVIDIA Hopper card (sm_90a).
//
// Three kernels behind one plain C entry point (loaded through ctypes by
// repro_torch/kernels/flash_attention.py); the launcher enqueues them on the
// stream it is given, allocates nothing (the wrapper passes an fp32
// scratch) and returns the first cudaGetLastError() that is not a success.
//
// Replaces no TPU kernel: the reference trains through XLA's autodiff of its
// plain _sdpa (src/repro/models/attention.py) and never differentiates its
// Pallas kernel. This is the gradient of the training forward
// (flash_attention.cu, ckio_flash_attention_train: tc_kernel writing each
// row's log-sum-exp). q (B,H,Sq,hd), k/v (B,K,Sk,hd), any element strides,
// query head h reads kv head h / G (G = H/K); causal with positions
// end-aligned (qpos = iq + Sk - Sq) and an optional window (qpos - kpos <
// window). bf16 in and out, hd 64 / 128 / 256, any Sq and Sk (ragged tails
// masked). With s = q.k * hd^-0.5, P = exp(s - lse), D = rowsum(dO o O):
//   dV = P^T dO,  dS = P o (dO V^T - D),  dK = scale dS^T Q,  dQ = scale dS K.
// P and dS are formed in fp32 and rounded to bf16 only as MMA operands.
//
// Bound: operations, 10 * B * H * hd * (kept (q, k) pairs) FLOPs (the five
// products S, dP, dV, dK, dQ) over 989 TFLOP/s: 0.130 ms for phi4-mini's
// microbatch (B=2, H=24, hd 128, S=2048 causal). The two kernels below do
// 14 of those 10 (S and dP are formed twice, once for dK/dV and once for dQ),
// the price of writing every gradient from one block with no atomics.
//
// 1. dot_kernel: one warp a query row: D = rowsum(dO o O) in fp32 and lse *
//    log2e, both written in the row order the two others walk: row f = iq *
//    G + g of kv head kh, padded to a multiple of 64 rows (zeros past F).
// 2. dkv_kernel: a block takes 64 keys of one kv head (32 at hd 256) and
//    walks the query rows of their band, 32 at a time (64 at hd 64), in
//    increasing order; the rows are the (position, head) pairs of the GQA
//    group, so the G query heads of a kv head are summed inside the block,
//    as tc_kernel shares its k/v tiles across the group. Where the key
//    tiles are too few to fill the card (MQA at B=1: 64 blocks of
//    recurrentgemma's hd-256 keys), `splits` blocks share a key tile, each
//    walking one contiguous part of its band's steps and writing fp32
//    partial sums; dkv_sum_kernel adds the parts in order and rounds them to
//    bf16 (the wrapper picks `splits` from the grid and the card's SMs; at
//    splits 1 the block writes dK/dV itself). Each of the 4 warps
//    owns 16 keys: S^T = K Q^T and dP^T = V dO^T stay in registers, P^T and
//    dS^T become the A operands of dV += P^T dO and dK += dS^T Q without a
//    trip through shared memory. At hd 256 the dK/dV accumulators of 16 keys
//    would take 256 registers a thread, so two warps share a key group and
//    each accumulates half of hd (S^T and dP^T are formed by both).
// 3. dq_kernel: tc_kernel's layout (64 query rows of a kv head a block, 4
//    warps of 16 rows, 64-key tiles, 32 at hd 256): S = Q K^T and dP = dO V^T
//    per tile, P recomputed from the lse, dQ += dS K in registers.
// Building blocks: ldmatrix feeding mma.sync.m16n8k16 (bf16 in, fp32
// accumulate), XOR-swizzled shared tiles double-buffered with 16-byte
// cp.async copies (scalar loads where a stride is not unit or not aligned),
// tiles every row keeps whole left unmasked, tiles outside the band skipped,
// the longest bands launched first.
//
// Deterministic: every gradient element is summed by one thread in a fixed
// order (query rows in increasing order for dK/dV, then the parts in
// increasing order where a key tile is split; key tiles for dQ); no
// atomics, so two runs give the same bits.
//
// What it leaves for later: wgmma and TMA (mma.sync reaches a fraction of
// the tensor cores' rate), warp specialisation, and one persistent launch
// for the two kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;           // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowPad = 64;             // the (B, K, Fp) rows are padded to it
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

struct BwdParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;
  const bf16* dout;
  const float* lse;   // (B, H, Sq), natural log
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* lse2;        // (B, K, Fp): lse * log2e of row f = iq * G + g
  float* dd;          // (B, K, Fp): D of that row
  float* pk;          // (splits, B, K, Sk, hd): dK / scale of each part
  float* pv;          // and dV (both unused at splits 1)
  // element strides: batch, head, position, dim
  long long qs[4], ks[4], vs[4], os[4], dos[4], dqs[4], dks[4], dvs[4];
  int H, K, Sq, Sk, G;
  int F, Fp;          // rows of a kv head: Sq * G, and padded
  int window;
  int splits;         // blocks sharing a key tile in dkv_kernel
  float scale;
};

// ============================================================================
// 1. D and the scaled lse (dot_kernel)
// ============================================================================

__global__ void __launch_bounds__(256) dot_kernel(const BwdParams p, int hd, long long rows) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int f = static_cast<int>(row % p.Fp);
  const int kh = static_cast<int>((row / p.Fp) % p.K);
  const long long b = row / (static_cast<long long>(p.Fp) * p.K);
  float d = 0.f, l2 = 0.f;
  if (f < p.F) {
    const long long h = static_cast<long long>(kh) * p.G + f % p.G;
    const long long iq = f / p.G;
    const bf16* dor = p.dout + b * p.dos[0] + h * p.dos[1] + iq * p.dos[2];
    const bf16* orow = p.o + b * p.os[0] + h * p.os[1] + iq * p.os[2];
    for (int e = lane; e < hd; e += 32)
      d = fmaf(__bfloat162float(dor[e * p.dos[3]]), __bfloat162float(orow[e * p.os[3]]), d);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(kFull, d, o);
    l2 = p.lse[(b * p.H + h) * p.Sq + iq] * kLog2e;
  }
  if (lane == 0) {
    p.dd[row] = d;
    p.lse2[row] = l2;
  }
}

// ============================================================================
// 2. dK and dV (dkv_kernel)
// ============================================================================

template <int HD>
struct DkvLayout {
  static constexpr int kSplit = HD >= 256 ? 2 : 1;   // warps sharing a key group
  static constexpr int kGroups = kWarps / kSplit;    // 16-key groups a block
  static constexpr int kBN = 16 * kGroups;           // keys a block
  static constexpr int kBM = HD <= 64 ? 64 : 32;     // query rows a step
  static constexpr int kHP = HD / kSplit;            // dims of dK/dV a warp sums
  static constexpr size_t kKV = 2 * kBN * HD;        // k or v, bf16
  static constexpr size_t kQ = 2 * kBM * HD;         // q or dO of a step
  static constexpr size_t kRowF = 4 * kBM;           // lse2 or D of a step
  static constexpr size_t kStage = 2 * kQ + 2 * kRowF;
  static constexpr size_t kBytes = 2 * kKV + 2 * kStage;   // k, v, 2 stages
};

template <int HD, bool VEC>
__global__ void __launch_bounds__(kThreads, 1) dkv_kernel(const BwdParams p) {
  using L = DkvLayout<HD>;
  constexpr int BN = L::kBN;
  constexpr int BM = L::kBM;
  constexpr int C = HD / 8;          // 16-byte chunks a row
  constexpr int NQ = BM / 8;         // n-tiles of a score tile (query rows)
  constexpr int NH = L::kHP / 8;     // n-tiles of the warp's dK / dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* k_sm = smem_raw;
  unsigned char* v_sm = smem_raw + L::kKV;
  unsigned char* st_sm = smem_raw + 2 * L::kKV;   // stage s: q, dO, lse2, D

  const int part = blockIdx.x % p.splits;
  const int n0 = blockIdx.x / p.splits * BN;
  const int kh = blockIdx.y;
  const long long b = blockIdx.z;
  const int nk = min(BN, p.Sk - n0);
  const int off = p.Sk - p.Sq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, tq = lane % 4;   // fragment row and column pair
  const int li = lane / 8, lr = lane % 8;   // ldmatrix: matrix, row in it
  const int kg = warp % L::kGroups;         // the warp's 16 keys
  const int hp = warp / L::kGroups;         // and its part of hd

  // Query rows that some key of the block keeps: qpos >= n0, and qpos -
  // kpos < window for the block's last key; walked from a multiple of BM,
  // the block taking its part of the steps.
  const int iq_lo = max(0, n0 - off);
  const int iq_hi = p.window > 0 ? min(p.Sq, n0 + nk - 1 + p.window - off) : p.Sq;
  const int f_lo = iq_lo * p.G, f_hi = iq_hi * p.G;
  const int m_first = (f_lo / BM) * BM;
  const int all_steps = f_hi > f_lo ? (f_hi - m_first + BM - 1) / BM : 0;
  const int per_part = (all_steps + p.splits - 1) / p.splits;
  const int s_lo = min(all_steps, part * per_part);
  const int steps = min(all_steps, s_lo + per_part) - s_lo;
  const int m_begin = m_first + s_lo * BM;

  const long long qbase = b * p.qs[0] + static_cast<long long>(kh) * p.G * p.qs[1];
  const long long dobase = b * p.dos[0] + static_cast<long long>(kh) * p.G * p.dos[1];
  const long long kbase = b * p.ks[0] + kh * p.ks[1];
  const long long vbase = b * p.vs[0] + kh * p.vs[1];
  const long long rowbase = (b * p.K + kh) * static_cast<long long>(p.Fp);

  auto stage_q = [&](int m0, int s) {
    unsigned char* dst = st_sm + s * L::kStage;
    const int n = min(BM, p.F - m0);
    tc_stage<HD, BM, VEC, kThreads>(dst, p.q, p.qs[3], n, [&](int r) {
      const int f = m0 + r;
      return qbase + static_cast<long long>(f % p.G) * p.qs[1] +
             static_cast<long long>(f / p.G) * p.qs[2];
    });
    tc_stage<HD, BM, VEC, kThreads>(dst + L::kQ, p.dout, p.dos[3], n, [&](int r) {
      const int f = m0 + r;
      return dobase + static_cast<long long>(f % p.G) * p.dos[1] +
             static_cast<long long>(f / p.G) * p.dos[2];
    });
    // lse2 and D of the step's rows: the padded layout keeps them in
    // bounds and 16-byte aligned.
    float* rows = reinterpret_cast<float*>(dst + 2 * L::kQ);
    for (int e = threadIdx.x; e < BM / 2; e += kThreads) {
      const int which = e / (BM / 4), c = e % (BM / 4);
      cp_async16(rows + which * BM + 4 * c,
                 (which ? p.dd : p.lse2) + rowbase + m0 + 4 * c, true);
    }
  };

  if (steps > 0) {
    tc_stage<HD, BN, VEC, kThreads>(k_sm, p.k, p.ks[3], nk, [&](int j) {
      return kbase + static_cast<long long>(n0 + j) * p.ks[2];
    });
    tc_stage<HD, BN, VEC, kThreads>(v_sm, p.v, p.vs[3], nk, [&](int j) {
      return vbase + static_cast<long long>(n0 + j) * p.vs[2];
    });
    stage_q(m_begin, 0);
    cp_async_commit();
  }

  float dv_acc[NH][4], dk_acc[NH][4];
#pragma unroll
  for (int j = 0; j < NH; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dv_acc[j][e] = 0.f;
      dk_acc[j][e] = 0.f;
    }
  const float sl2 = p.scale * kLog2e;
  const unsigned k_addr = smem_u32(k_sm), v_addr = smem_u32(v_sm);
  const int krow0 = 16 * kg;
  int kpos[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) kpos[hr] = n0 + krow0 + gr + 8 * hr;

  for (int i = 0; i < steps; ++i) {
    const int s = i & 1;
    const int m0 = m_begin + i * BM;
    if (i + 1 < steps) {
      stage_q(m0 + BM, s ^ 1);              // in flight while this step runs
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    unsigned char* stage = st_sm + s * L::kStage;
    const unsigned q_addr = smem_u32(stage), do_addr = smem_u32(stage + L::kQ);
    const float* lse_s = reinterpret_cast<const float*>(stage + 2 * L::kQ);
    const float* d_s = lse_s + BM;

    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x BM rows.
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        st[j][e] = 0.f;
        dpt[j][e] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      unsigned ak[4], avv[4];
      ldsm_x4(ak, k_addr + swz<C>(krow0 + lane % 16, 2 * kk + lane / 16));
      ldsm_x4(avv, v_addr + swz<C>(krow0 + lane % 16, 2 * kk + lane / 16));
#pragma unroll
      for (int nn = 0; nn < NQ / 2; ++nn) {
        unsigned bq[4];
        ldsm_x4(bq, q_addr + swz<C>(16 * nn + 8 * (li / 2) + lr, 2 * kk + li % 2));
        mma_bf16(st[2 * nn], ak, bq[0], bq[1]);
        mma_bf16(st[2 * nn + 1], ak, bq[2], bq[3]);
        ldsm_x4(bq, do_addr + swz<C>(16 * nn + 8 * (li / 2) + lr, 2 * kk + li % 2));
        mma_bf16(dpt[2 * nn], avv, bq[0], bq[1]);
        mma_bf16(dpt[2 * nn + 1], avv, bq[2], bq[3]);
      }
    }

    // P^T and dS^T in fp32; a tile that every (row, key) pair keeps needs
    // no mask.
    const bool whole = m0 + BM <= p.F && n0 + BN <= p.Sk &&
                       m0 / p.G + off >= n0 + BN - 1 &&
                       (p.window <= 0 || (m0 + BM - 1) / p.G + off - n0 < p.window);
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * tq + (e & 1);
        const int hr = e / 2;
        bool ok = true;
        if (!whole) {
          const int f = m0 + col;
          const int qpos = f / p.G + off;
          ok = f < p.F && kpos[hr] < p.Sk && kpos[hr] <= qpos &&
               (p.window <= 0 || qpos - kpos[hr] < p.window);
        }
        const float pe = ok ? ex2(st[j][e] * sl2 - lse_s[col]) : 0.f;
        st[j][e] = pe;
        dpt[j][e] = ok ? pe * (dpt[j][e] - d_s[col]) : 0.f;
      }

    // dV += P^T dO and dK += dS^T Q over the warp's part of hd, P^T and
    // dS^T rounded to bf16 in the A-fragment layout.
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      unsigned ap[4], ad[4];
      ap[0] = pack_bf16(st[2 * kk][0], st[2 * kk][1]);
      ap[1] = pack_bf16(st[2 * kk][2], st[2 * kk][3]);
      ap[2] = pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
      ap[3] = pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
      ad[0] = pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]);
      ad[1] = pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]);
      ad[2] = pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
      ad[3] = pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
#pragma unroll
      for (int nn = 0; nn < NH / 2; ++nn) {
        const int c = hp * NH + 2 * nn + li / 2;
        unsigned bb[4];
        ldsm_x4_t(bb, do_addr + swz<C>(16 * kk + 8 * (li % 2) + lr, c));
        mma_bf16(dv_acc[2 * nn], ap, bb[0], bb[1]);
        mma_bf16(dv_acc[2 * nn + 1], ap, bb[2], bb[3]);
        ldsm_x4_t(bb, q_addr + swz<C>(16 * kk + 8 * (li % 2) + lr, c));
        mma_bf16(dk_acc[2 * nn], ad, bb[0], bb[1]);
        mma_bf16(dk_acc[2 * nn + 1], ad, bb[2], bb[3]);
      }
    }
    __syncthreads();                         // stage s is free again
  }

  // Keys that no row keeps get zeros; a part writes its fp32 sums.
  if (p.splits > 1) {
    const long long pbase =
        ((static_cast<long long>(part) * gridDim.z + b) * p.K + kh) * p.Sk;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (kpos[hr] >= n0 + nk) continue;
      float* pkr = p.pk + (pbase + kpos[hr]) * HD;
      float* pvr = p.pv + (pbase + kpos[hr]) * HD;
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        const int d = hp * L::kHP + 8 * j + 2 * tq;
        *reinterpret_cast<float2*>(pkr + d) = make_float2(dk_acc[j][2 * hr], dk_acc[j][2 * hr + 1]);
        *reinterpret_cast<float2*>(pvr + d) = make_float2(dv_acc[j][2 * hr], dv_acc[j][2 * hr + 1]);
      }
    }
    return;
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (kpos[hr] >= n0 + nk) continue;
    bf16* dkr = p.dk + b * p.dks[0] + kh * p.dks[1] + kpos[hr] * p.dks[2];
    bf16* dvr = p.dv + b * p.dvs[0] + kh * p.dvs[1] + kpos[hr] * p.dvs[2];
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      const int d = hp * L::kHP + 8 * j + 2 * tq;
      dkr[d * p.dks[3]] = __float2bfloat16(dk_acc[j][2 * hr] * p.scale);
      dkr[(d + 1) * p.dks[3]] = __float2bfloat16(dk_acc[j][2 * hr + 1] * p.scale);
      dvr[d * p.dvs[3]] = __float2bfloat16(dv_acc[j][2 * hr]);
      dvr[(d + 1) * p.dvs[3]] = __float2bfloat16(dv_acc[j][2 * hr + 1]);
    }
  }
}

// The parts of a split key tile, added in increasing order: two elements a
// thread of the (B, K, Sk, hd) partial layout.
__global__ void __launch_bounds__(256) dkv_sum_kernel(const BwdParams p, int hd, long long pairs) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= pairs) return;
  const long long e = 2 * i;
  const int d = static_cast<int>(e % hd);
  const long long row = e / hd;                 // (b * K + kh) * Sk + key
  const int key = static_cast<int>(row % p.Sk);
  const int kh = static_cast<int>((row / p.Sk) % p.K);
  const long long b = row / (static_cast<long long>(p.Sk) * p.K);
  float2 sk = make_float2(0.f, 0.f), sv = make_float2(0.f, 0.f);
  for (int s = 0; s < p.splits; ++s) {
    const float2 a = *reinterpret_cast<const float2*>(p.pk + s * 2 * pairs + e);
    const float2 c = *reinterpret_cast<const float2*>(p.pv + s * 2 * pairs + e);
    sk.x += a.x;
    sk.y += a.y;
    sv.x += c.x;
    sv.y += c.y;
  }
  bf16* dkr = p.dk + b * p.dks[0] + kh * p.dks[1] + key * p.dks[2];
  bf16* dvr = p.dv + b * p.dvs[0] + kh * p.dvs[1] + key * p.dvs[2];
  dkr[d * p.dks[3]] = __float2bfloat16(sk.x * p.scale);
  dkr[(d + 1) * p.dks[3]] = __float2bfloat16(sk.y * p.scale);
  dvr[d * p.dvs[3]] = __float2bfloat16(sv.x);
  dvr[(d + 1) * p.dvs[3]] = __float2bfloat16(sv.y);
}

// ============================================================================
// 3. dQ (dq_kernel)
// ============================================================================

template <int HD>
struct DqLayout {
  static constexpr int kRows = 16 * kWarps;           // query rows a block
  static constexpr int kBK = HD >= 256 ? 32 : 64;     // keys a tile
  static constexpr size_t kQ = 2 * kRows * HD;        // q or dO, bf16
  static constexpr size_t kTile = 2 * kBK * HD;
  static constexpr size_t kBytes = 2 * kQ + 4 * kTile;   // q, dO, 2 stages of k and v
};

template <int HD, bool VEC>
__global__ void __launch_bounds__(kThreads, 1) dq_kernel(const BwdParams p) {
  using L = DqLayout<HD>;
  constexpr int ROWS = L::kRows;
  constexpr int BK = L::kBK;
  constexpr int C = HD / 8;
  constexpr int NT = BK / 8;                // n-tiles of a score tile
  constexpr int NO = HD / 8;                // n-tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* q_sm = smem_raw;
  unsigned char* do_sm = smem_raw + L::kQ;
  unsigned char* kv_sm = smem_raw + 2 * L::kQ;   // stage s: k at 2s, v at 2s + 1

  // Rows of a kv head: f = iq * G + g; the longest key ranges first.
  const int chunk = gridDim.x - 1 - blockIdx.x;
  const int kh = blockIdx.y;
  const long long b = blockIdx.z;
  const int f0 = chunk * ROWS;
  const int nrows = min(ROWS, p.F - f0);
  const int off = p.Sk - p.Sq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, tq = lane % 4;
  const int li = lane / 8, lr = lane % 8;
  const int wr0 = 16 * warp;

  const long long qbase = b * p.qs[0] + static_cast<long long>(kh) * p.G * p.qs[1];
  const long long dobase = b * p.dos[0] + static_cast<long long>(kh) * p.G * p.dos[1];
  const long long kbase = b * p.ks[0] + kh * p.ks[1];
  const long long vbase = b * p.vs[0] + kh * p.vs[1];
  const long long rowbase = (b * p.K + kh) * static_cast<long long>(p.Fp);

  // The block's band of keys, and each warp's.
  auto band = [&](int r_lo, int r_hi, int& kb0, int& kb1) {
    const int lo = (f0 + r_lo) / p.G + off, hi = (f0 + r_hi) / p.G + off;
    kb0 = p.window > 0 ? max(0, lo - p.window + 1) : 0;
    kb1 = min(p.Sk, hi + 1);
  };
  int k_begin, k_end, w_begin = 0, w_end = 0;
  band(0, nrows - 1, k_begin, k_end);
  const int w_last = min(nrows, wr0 + 16) - 1;
  if (wr0 < nrows) band(wr0, w_last, w_begin, w_end);
  const int t0 = k_begin / BK;
  const int t1 = k_end > k_begin ? (k_end + BK - 1) / BK : t0;

  int qpos[2];
  float lse2[2], dd[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = wr0 + gr + 8 * hr;
    const bool in = r < nrows;
    qpos[hr] = in ? (f0 + r) / p.G + off : -(1 << 30);
    lse2[hr] = in ? p.lse2[rowbase + f0 + r] : 0.f;
    dd[hr] = in ? p.dd[rowbase + f0 + r] : 0.f;
  }
  float dq_acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;
  const float sl2 = p.scale * kLog2e;

  auto stage_kv = [&](int t, int s) {
    const int k0 = t * BK;
    const int n = min(BK, p.Sk - k0);
    tc_stage<HD, BK, VEC, kThreads>(kv_sm + (2 * s) * L::kTile, p.k, p.ks[3], n,
                                    [&](int j) { return kbase + (k0 + j) * p.ks[2]; });
    tc_stage<HD, BK, VEC, kThreads>(kv_sm + (2 * s + 1) * L::kTile, p.v, p.vs[3], n,
                                    [&](int j) { return vbase + (k0 + j) * p.vs[2]; });
  };

  if (t1 > t0) {
    tc_stage<HD, ROWS, VEC, kThreads>(q_sm, p.q, p.qs[3], nrows, [&](int r) {
      const int f = f0 + r;
      return qbase + static_cast<long long>(f % p.G) * p.qs[1] +
             static_cast<long long>(f / p.G) * p.qs[2];
    });
    tc_stage<HD, ROWS, VEC, kThreads>(do_sm, p.dout, p.dos[3], nrows, [&](int r) {
      const int f = f0 + r;
      return dobase + static_cast<long long>(f % p.G) * p.dos[1] +
             static_cast<long long>(f / p.G) * p.dos[2];
    });
    stage_kv(t0, 0);
    cp_async_commit();
  }
  const unsigned q_addr = smem_u32(q_sm), do_addr = smem_u32(do_sm);
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

      // S = Q K^T and dP = dO V^T: 16 rows x BK keys a warp.
      float sacc[NT][4], dpacc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sacc[j][e] = 0.f;
          dpacc[j][e] = 0.f;
        }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        unsigned aq[4], ado[4];
        ldsm_x4(aq, q_addr + swz<C>(wr0 + lane % 16, 2 * kk + lane / 16));
        ldsm_x4(ado, do_addr + swz<C>(wr0 + lane % 16, 2 * kk + lane / 16));
#pragma unroll
        for (int nn = 0; nn < NT / 2; ++nn) {
          unsigned bk[4];
          ldsm_x4(bk, k_addr + swz<C>(16 * nn + 8 * (li / 2) + lr, 2 * kk + li % 2));
          mma_bf16(sacc[2 * nn], aq, bk[0], bk[1]);
          mma_bf16(sacc[2 * nn + 1], aq, bk[2], bk[3]);
          ldsm_x4(bk, v_addr + swz<C>(16 * nn + 8 * (li / 2) + lr, 2 * kk + li % 2));
          mma_bf16(dpacc[2 * nn], ado, bk[0], bk[1]);
          mma_bf16(dpacc[2 * nn + 1], ado, bk[2], bk[3]);
        }
      }

      // dS = P o (dP - D), P = exp2(s log2e scale - lse2); a tile that
      // every row of the warp keeps whole needs no mask.
      const bool whole = wr0 + 16 <= nrows && k0 + BK <= p.Sk &&
                         k0 + BK - 1 <= (f0 + wr0) / p.G + off &&
                         (p.window <= 0 || (f0 + w_last) / p.G + off - k0 < p.window);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e / 2;
          bool ok = true;
          if (!whole) {
            const int kpos = k0 + 8 * j + 2 * tq + (e & 1);
            ok = kpos < p.Sk && kpos <= qpos[hr] &&
                 (p.window <= 0 || qpos[hr] - kpos < p.window);
          }
          const float pe = ok ? ex2(sacc[j][e] * sl2 - lse2[hr]) : 0.f;
          sacc[j][e] = ok ? pe * (dpacc[j][e] - dd[hr]) : 0.f;
        }

      // dQ += dS K, dS rounded to bf16 in the A-fragment layout.
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        unsigned a[4];
        a[0] = pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]);
        a[1] = pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]);
        a[2] = pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]);
        a[3] = pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3]);
#pragma unroll
        for (int nn = 0; nn < NO / 2; ++nn) {
          unsigned bk[4];
          ldsm_x4_t(bk, k_addr + swz<C>(16 * kk + 8 * (li % 2) + lr, 2 * nn + li / 2));
          mma_bf16(dq_acc[2 * nn], a, bk[0], bk[1]);
          mma_bf16(dq_acc[2 * nn + 1], a, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();                         // stage s is free again
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = wr0 + gr + 8 * hr;
    if (r >= nrows) continue;
    const int f = f0 + r;
    const long long h = static_cast<long long>(kh) * p.G + f % p.G;
    const long long iq = f / p.G;
    bf16* out = p.dq + b * p.dqs[0] + h * p.dqs[1] + iq * p.dqs[2];
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int d = 8 * j + 2 * tq;
      out[d * p.dqs[3]] = __float2bfloat16(dq_acc[j][2 * hr] * p.scale);
      out[(d + 1) * p.dqs[3]] = __float2bfloat16(dq_acc[j][2 * hr + 1] * p.scale);
    }
  }
}

// ============================================================================
// Launcher
// ============================================================================

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int HD, bool VEC>
cudaError_t launch(const BwdParams& p, long long B, cudaStream_t st) {
  using KV = DkvLayout<HD>;
  using Q = DqLayout<HD>;
  static const cudaError_t a1 = allow_smem(dkv_kernel<HD, VEC>, KV::kBytes);
  static const cudaError_t a2 = allow_smem(dq_kernel<HD, VEC>, Q::kBytes);
  if (a1 != cudaSuccess) return a1;
  if (a2 != cudaSuccess) return a2;
  const unsigned Kh = static_cast<unsigned>(p.K), Bu = static_cast<unsigned>(B);
  if (p.Sk > 0) {
    const unsigned tiles = static_cast<unsigned>((p.Sk + KV::kBN - 1) / KV::kBN);
    const dim3 g(tiles * static_cast<unsigned>(p.splits), Kh, Bu);
    dkv_kernel<HD, VEC><<<g, kThreads, KV::kBytes, st>>>(p);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (p.splits > 1) {
      const long long pairs = B * p.K * static_cast<long long>(p.Sk) * HD / 2;
      dkv_sum_kernel<<<static_cast<unsigned>((pairs + 255) / 256), 256, 0, st>>>(p, HD, pairs);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  const dim3 g(static_cast<unsigned>((p.F + Q::kRows - 1) / Q::kRows), Kh, Bu);
  dq_kernel<HD, VEC><<<g, kThreads, Q::kBytes, st>>>(p);
  return cudaGetLastError();
}

bool vec_ok(const void* ptr, const long long* s, const long long* sizes) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0 || s[3] != 1) return false;
  for (int i = 0; i < 3; ++i)
    if (sizes[i] > 1 && (s[i] * 2) % 16 != 0) return false;
  return true;
}

}  // namespace

// dims (host memory): B, H, K, Sq, Sk, then the element strides (batch,
// head, position, dim) of q, k, v, o, dout, dq, dk and dv, then splits (the
// blocks sharing a key tile, 1 to 64). lse: B*H*Sq floats from
// ckio_flash_attention_train. scratch: 2*B*K*Fp floats, Fp = Sq*(H/K)
// rounded up to a multiple of 64, and 2*splits*B*K*Sk*hd more where splits
// > 1. hd in {64, 128, 256}.
extern "C" int ckio_flash_attention_backward(const void* q, const void* k, const void* v,
                                             const void* o, const void* dout,
                                             const float* lse, void* dq, void* dk,
                                             void* dv, float* scratch,
                                             const long long* dims, int hd, int window,
                                             double scale, void* stream) {
  BwdParams p = {};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<const bf16*>(o);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = lse;
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  const long long B = dims[0];
  p.H = static_cast<int>(dims[1]);
  p.K = static_cast<int>(dims[2]);
  p.Sq = static_cast<int>(dims[3]);
  p.Sk = static_cast<int>(dims[4]);
  long long* strides[8] = {p.qs, p.ks, p.vs, p.os, p.dos, p.dqs, p.dks, p.dvs};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 4; ++i) strides[t][i] = dims[5 + 4 * t + i];
  const long long splits = dims[37];
  if (B < 1 || B > 65535 || p.K < 1 || p.K > 65535 || p.H % p.K != 0 || p.Sq < 1 ||
      p.Sk < 0 || window < 0 || scratch == nullptr || (hd != 64 && hd != 128 && hd != 256) ||
      splits < 1 || splits > 64 || (p.Sk + 31) / 32 * splits > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  p.G = p.H / p.K;
  const long long F = static_cast<long long>(p.Sq) * p.G;
  const long long Fp = (F + kRowPad - 1) / kRowPad * kRowPad;
  const long long rows = B * p.K * Fp;
  if (Fp > 0x7fffffffLL || rows / 8 + 1 > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  p.F = static_cast<int>(F);
  p.Fp = static_cast<int>(Fp);
  p.window = window;
  p.scale = static_cast<float>(scale);
  p.splits = static_cast<int>(splits);
  p.lse2 = scratch;
  p.dd = scratch + rows;
  p.pk = scratch + 2 * rows;
  p.pv = p.pk + splits * B * p.K * static_cast<long long>(p.Sk) * hd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  dot_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, st>>>(p, hd, rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long qsz[3] = {B, p.H, p.Sq}, ksz[3] = {B, p.K, p.Sk};
  const bool vec = vec_ok(q, p.qs, qsz) && vec_ok(k, p.ks, ksz) && vec_ok(v, p.vs, ksz) &&
                   vec_ok(dout, p.dos, qsz);
  return static_cast<int>(
      hd == 64    ? (vec ? launch<64, true>(p, B, st) : launch<64, false>(p, B, st))
      : hd == 128 ? (vec ? launch<128, true>(p, B, st) : launch<128, false>(p, B, st))
      : hd == 256 ? (vec ? launch<256, true>(p, B, st) : launch<256, false>(p, B, st))
                  : cudaErrorInvalidValue);
}
