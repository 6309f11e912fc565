// The gradient of the literal Mamba-1 selective scan on an NVIDIA Hopper
// card (sm_90a): scan_bwd_cluster_kernel, the backward of scan_kernel
// (csrc/mamba_scan.cu).
//
// Two entries with a plain C interface (loaded through ctypes by
// repro_torch/kernels/mamba_scan.py): ckio_mamba_scan_backward launches
// scan_bwd_cluster_kernel on the plan of scan_bwd_plan, then
// ordered_sum_kernel for dC; ckio_mamba_scan_backward_clusters asks the card
// how many clusters of a plan's shape it runs at once. The launcher enqueues
// on the stream it is given, allocates nothing, and returns the first CUDA
// error (a refused plan before any launch).
//
#include <climits>
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_math.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// scan_bwd_cluster_kernel — the gradient of scan_kernel (the literal entry).
//   No TPU kernel: the reference differentiates _chunked_scan (src/repro/
//   models/ssm.py) with XLA. From gy (B,S,D) and the forward's inputs:
//     g_t    = gy_t[d] C_t[n] + Abar_{t+1} g_{t+1}       (g_S = 0)
//     dBx_t  = g_t,  dAbar_t = g_t h_{t-1},  dh0 = Abar_0 g_0
//     dC_t[n] = sum_d gy_t[d] h_t[d,n]
//
//   Bound: bytes. Abar, Bx read once and dAbar, dBx written once are 16
//   bytes a state element; with gy, C and dC, 8.72 GB -> 2.604 ms at 3.35
//   TB/s at B=2, S=2048, D=8192, N=16. The 8 FLOPs a state element are 0.06
//   ms at 67 TFLOP/s.
//
//   Design (the plan is scan_bwd_plan in kernels/mamba_scan.py). An item is
//   a batch row b and a group of G states (G/N channels; G = 96 at N = 16).
//   A thread-block cluster of K = 16 blocks (a non-portable size) takes
//   items in turn, as many clusters as the card runs at once (one block an
//   SM: 7 on an H100, 112 SMs); rank k owns chunk k of L steps of each
//   item, four threads a state, each a sub-chunk of L/4 steps. For every
//   item a block
//   (0) has its chunk of Abar, Bx, gy and C copied into shared memory by
//       four TMA tensor copies (boxes of L steps) that complete on the
//       buffer's mbarrier. There are two buffers: the next item's copies
//       are issued while the cluster's blocks meet at the barrier of (1),
//       into the buffer the item before has left once its stores have read
//       it;
//   (1) walks each sub-chunk forward from zero: P = prod Abar, the local
//       end state e and the local adjoint r = sum_t (prod_{s<=t} Abar_s)
//       gy_t C_t (Abar_first g_first with a zero carry), and folds the four
//       into the chunk's (P, e, r). The blocks of the cluster exchange these
//       through distributed shared memory: block k folds its predecessors'
//       (P, e) in rank order from the item's state (h <- P h + e) and its
//       successors' (P, r) in reverse from the adjoint carry (q <- P q + r),
//       then each sub-chunk its own carries the same way;
//   (2) walks each sub-chunk forward from its state carry, leaving h_t in
//       Bx's slot, and the block sums gy_t h_t over its channels, a warp a
//       row, into `part` (B, nblk, S, N), which ordered_sum_kernel adds over
//       the nblk groups in order;
//   (3) walks each sub-chunk backward from its adjoint carry q = Abar_{t+1}
//       g_{t+1}, leaving dBx in h's slot and dAbar in Abar's, which two TMA
//       tensor stores write once (steps past S clipped).
//   So Abar and Bx are read once and dAbar and dBx written once; the TMA
//   unit moves them, no thread's load slots (4-byte cp.async a thread, 256
//   a task, stalled the walks' shared loads behind them). Blocks of a wave
//   start together and stay in step, so one block an SM with two buffers,
//   not two blocks, overlaps copies with walks. What is left is the
//   cluster's barrier: each item waits for the slowest of its 16 blocks
//   (arrive, stage the next item, then wait, hides a part of it).
//   The card runs a cluster's blocks together, so no block waits on one
//   that has not started. Where L would pass 256 steps (one TMA box) or the
//   buffers of 32 states would not fit (long S), the cluster walks the
//   sequence in W windows of K chunks: forward windows leave each window's
//   carry-in state in `carry` (B, W, D, N), then the windows are finished
//   from the last to the first, the adjoint carried from each to the one
//   before; 24 bytes a state element. Where a row of an operand does not
//   start 16-byte aligned (D not a multiple of 4, N < 4) each thread copies
//   its state's rows with cp.async and stores its gradients itself. Every
//   sum has a fixed order and no atomics: two runs give the same bits.
constexpr int kBwdMaxStates = 128;   // states a block (mamba_scan.py)
constexpr int kBwdMaxCluster = 16;
constexpr int kBwdMaxChunk = 256;    // steps a chunk: one TMA box of rows
constexpr int kBwdSplit = 4;         // threads a state: sub-chunks a chunk
constexpr int kBwdBatch = 8;         // steps a walk loads at once

struct alignas(64) BwdArgs {
  // The TMA path's maps of (B, S, cols) tensors, boxes of L steps of one
  // batch row (steps past S are read as 0 and not written): Abar, Bx, dAbar
  // and dBx in G columns, gy in bwd_gy_cols columns from the group's first
  // channel rounded down to 4 (a box starts 16-byte aligned), C whole.
  CUtensorMap tA, tX, tGy, tC, tdA, tdB;
  const float* A;
  const float* Bx;
  const float* C;
  const float* h0;
  const float* gy;
  float* dA;
  float* dBx;
  float* part;
  float* dh0;
  float* carry;
  long long B, S, D;
  int L, W, nblk;
};

// Shared-memory floats of a block: two buffers, each of Abar and Bx (L x G
// each), gy (L x bwd_gy_cols, rounded up to 128 bytes) and C (L x N),
// rounded up to 128 bytes; the sub-chunks' (P, e, r) (kBwdSplit x 3 x G);
// two of the chunk's (P, e, r) (3 x G); the chunk's carries (2 x G); two
// 8-byte mbarriers. A gy row holds the group's Gc = G/N channels from the
// group's first channel rounded down to 4, an offset that is a multiple of
// gcd(Gc, 4) below 4.
__host__ __device__ constexpr int bwd_gy_cols(int G, int N) {
  const int gc = G / N, low = gc & -gc, g = low < 4 ? low : 4;
  return (gc + 4 - g + 3) / 4 * 4;
}
__host__ __device__ constexpr long long bwd_gy_floats(int G, int L, int N) {
  return (static_cast<long long>(L) * bwd_gy_cols(G, N) + 31) / 32 * 32;
}
__host__ __device__ constexpr long long bwd_buffer_floats(int G, int L, int N) {
  return (2LL * L * G + bwd_gy_floats(G, L, N) + static_cast<long long>(L) * N +
          31) / 32 * 32;
}
__host__ __device__ constexpr long long bwd_smem_floats(int G, int L, int N) {
  return 2 * bwd_buffer_floats(G, L, N) + (3 * kBwdSplit + 8) * G + 4;
}

// 4 bytes from global to shared memory, or 4 zero bytes when !full.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}
// An mbarrier in shared memory: init, arrive with the bytes to expect, and
// wait for a phase; a TMA copy of a box of a (B, S, cols) tensor that
// completes on it.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra.uni DONE;\n"
      "bra.uni WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map,
                                         int col, int t, int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(t), "r"(b),
      "r"(smem_u32(bar))
      : "memory");
}
// A box from shared memory to the tensor, in this thread's bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const float* src, int col, int t,
                                          int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(col), "r"(t), "r"(b)
      : "memory");
}

// GT: the block's states when fixed at compile time (the TMA path: 32, 64,
// 96 or 128, so that every stride in shared memory is an immediate), else
// 0 and blockDim.x / kBwdSplit.
template <int N, bool kTma, int GT>
__global__ void __launch_bounds__(kBwdMaxStates * kBwdSplit, 1)
scan_bwd_cluster_kernel(const __grid_constant__ BwdArgs a) {
  namespace cg = cooperative_groups;
  constexpr int KM = kBwdMaxCluster, M = kBwdSplit, U = kBwdBatch;
  extern __shared__ __align__(128) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int nthr = GT > 0 ? GT * M : blockDim.x, G = nthr / M;
  const int tid = threadIdx.x;
  const int j = tid % G, m = tid / G;   // state j of the group, sub-chunk m
  const int L = a.L, Gc = G / N, Gc4 = bwd_gy_cols(G, N);
  const int sub = (L + M - 1) / M;
  const int lane = tid % 32, warp = tid / 32;
  const int c = j / N, n = j % N;
  const long long DN = a.D * N;
  const long long span = static_cast<long long>(K) * L;
  const long long bufsz = bwd_buffer_floats(G, L, N);
  float* sSub = smem + 2 * bufsz;       // [M][3][G]: sub-chunks' (P, e, r)
  float* sAgg0 = sSub + 3 * M * G;      // [2][3][G]: the chunk's, twice
  float* sCar = sAgg0 + 6 * G;          // [2][G]: the chunk's carries
  uint64_t* bars = reinterpret_cast<uint64_t*>(sCar + 2 * G);
  // The cluster's tasks: items (b, group) cid, cid + ncl, ...; an item is
  // W - 1 forward windows, then its W windows from the last to the first.
  const long long cid = blockIdx.x / K, ncl = gridDim.x / K;
  const long long items = a.B * a.nblk;
  const int T = 2 * a.W - 1;
  const long long mine = cid < items ? (items - cid + ncl - 1) / ncl : 0;
  const long long ntasks = mine * T;
  struct Task {
    long long b, grp, t0;
    int w, len;
    bool fwd;
  };
  auto task = [&](long long tau) {
    Task k;
    const long long item = cid + (tau / T) * ncl;
    const int r = static_cast<int>(tau % T);
    k.b = item / a.nblk;
    k.grp = item % a.nblk;
    k.fwd = r < a.W - 1;
    k.w = k.fwd ? r : 2 * a.W - 2 - r;
    k.t0 = k.w * span + static_cast<long long>(rank) * L;
    k.len = static_cast<int>(max(0LL, min(static_cast<long long>(L),
                                          a.S - k.t0)));
    return k;
  };
  // (0) Copies task tau's chunk into buffer p: Abar, Bx and, for a
  // backward window, gy and C, by TMA from one thread (with !kTma each
  // thread copies its state's rows of its sub-chunk and a share of the gy
  // and C rows by cp.async, one group).
  auto stage = [&](int p, long long tau) {
    if (tau < ntasks) {
      const Task k = task(tau);
      float* sA = smem + p * bufsz;
      float* sX = sA + L * G;
      float* sGy = sX + L * G;
      float* sC = sGy + bwd_gy_floats(G, L, N);
      const long long row0 = k.b * a.S + k.t0;
      const long long first = k.grp * G;
      const long long gy0 = k.grp * Gc / 4 * 4;   // the gy box's first column
      if (kTma) {
        if (tid == 0) {
          const int t0 = static_cast<int>(k.t0), b = static_cast<int>(k.b);
          const int cols = 2 * G + (k.fwd ? 0 : Gc4 + N);   // a row's floats
          mbar_expect(bars + p, k.len > 0 ? 4u * L * cols : 0u);
          if (k.len > 0) {
            tma_load(sA, &a.tA, static_cast<int>(first), t0, b, bars + p);
            tma_load(sX, &a.tX, static_cast<int>(first), t0, b, bars + p);
            if (!k.fwd) {
              tma_load(sGy, &a.tGy, static_cast<int>(gy0), t0, b, bars + p);
              tma_load(sC, &a.tC, 0, t0, b, bars + p);
            }
          }
        }
      } else {
        const long long state = first + j;
        const bool valid = state < DN;
        const float* pa = a.A + row0 * DN + (valid ? state : 0);
        const float* px = a.Bx + row0 * DN + (valid ? state : 0);
        const int t1 = min(k.len, (m + 1) * sub);
        for (int t = m * sub; t < t1; ++t) {
          cp_async4(sA + t * G + j, pa + t * DN, valid);
          cp_async4(sX + t * G + j, px + t * DN, valid);
        }
      }
      if (!kTma && !k.fwd) {
        const long long d0 = k.grp * Gc;
        for (int i = tid; i < k.len * Gc; i += nthr) {
          const int t = i / Gc, cc = i % Gc;
          const bool in = d0 + cc < a.D;
          cp_async4(sGy + t * Gc4 + (d0 - gy0) + cc,
                    a.gy + (row0 + t) * a.D + (in ? d0 + cc : 0), in);
        }
        for (int i = tid; i < k.len * N; i += nthr)
          cp_async4(sC + i, a.C + row0 * N + i, true);
      }
    }
    cp_async_commit();   // an empty group past the last task
  };

  if (kTma && tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  stage(0, 0);
  float hc = 0.f, qc = 0.f;   // the window's state and adjoint carries
  for (long long tau = 0; tau < ntasks; ++tau) {
    const int p = static_cast<int>(tau & 1);
    const Task k = task(tau);
    float* sA = smem + p * bufsz;
    float* sX = sA + L * G;
    float* sGy = sX + L * G;
    float* sC = sGy + bwd_gy_floats(G, L, N);
    float* sAgg = sAgg0 + p * 3 * G;
    const float* gyc = sGy + (k.grp * Gc) % 4;   // gy row t, channel c'
                                                  // at gyc[t * Gc4 + c']
    float* mA = sA + j;   // this thread's state: row t at t * G
    float* mX = sX + j;
    const long long state = k.grp * G + j;
    const bool valid = state < DN;
    const int s0 = min(k.len, m * sub), s1 = min(k.len, (m + 1) * sub);
    const float h0v = a.h0 != nullptr && valid && m == 0
                          ? a.h0[k.b * DN + state] : 0.f;
    if (tau % T == 0) {   // an item's first task
      hc = h0v;
      qc = 0.f;
    }
    if (kTma) {
      // Each thread waits for the copies itself; the task before ended on
      // a barrier.
      mbar_wait(bars + p, static_cast<unsigned>((tau >> 1) & 1));
    } else {
      cp_async_wait_all();
      __syncthreads();
    }
    // (1) the sub-chunk from zero: P, e and (backward) r. The walks take
    // U steps at a time, loads first; `cnt` < U only in the last batch.
    {
      float h = 0.f, pr = 1.f, r = 0.f;
      auto run = [&](int t, int cnt, bool with_u) {
        float av[U], xv[U], uv[U];
#pragma unroll
        for (int i = 0; i < U; ++i) {
          const bool in = i < cnt;
          av[i] = in ? mA[(t + i) * G] : 1.f;
          xv[i] = in ? mX[(t + i) * G] : 0.f;
          uv[i] = in && with_u
                      ? gyc[(t + i) * Gc4 + c] * sC[(t + i) * N + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < U; ++i) {
          h = fmaf(av[i], h, xv[i]);
          pr *= av[i];
          r = fmaf(pr, uv[i], r);
        }
      };
      int t = s0;
      if (k.fwd) {
        for (; t + U <= s1; t += U) run(t, U, false);
        if (t < s1) run(t, s1 - t, false);
      } else {
        for (; t + U <= s1; t += U) run(t, U, true);
        if (t < s1) run(t, s1 - t, true);
      }
      sSub[(3 * m) * G + j] = pr;
      sSub[(3 * m + 1) * G + j] = h;
      sSub[(3 * m + 2) * G + j] = r;
    }
    __syncthreads();
    if (m == 0) {   // the chunk's (P, e, r): its sub-chunks folded in order
      float pr = 1.f, e = 0.f, r = 0.f;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        e = fmaf(sSub[(3 * i) * G + j], e, sSub[(3 * i + 1) * G + j]);
        pr *= sSub[(3 * i) * G + j];
      }
#pragma unroll
      for (int i = M - 1; i >= 0; --i)
        r = fmaf(sSub[(3 * i) * G + j], r, sSub[(3 * i + 2) * G + j]);
      sAgg[j] = pr;
      sAgg[G + j] = e;
      sAgg[2 * G + j] = r;
    }
    // Arrive at the cluster's barrier; while the other blocks arrive, the
    // next task's copies start, into the buffer the task before has left
    // once its stores have read it; then wait.
    asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
    if (kTma && tid == 0)
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    stage(p ^ 1, tau + 1);
    asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
    if (m == 0) {
      // This state's (P, e, r) of every chunk of the cluster, loaded
      // together, folded into the chunk's carries.
      float P[KM], E[KM], Q[KM];
#pragma unroll
      for (int i = 0; i < KM; ++i) {
        if (i < K) {
          const float* q = cluster.map_shared_rank(sAgg, i);
          P[i] = q[j];
          E[i] = q[G + j];
          Q[i] = q[2 * G + j];
        }
      }
      if (k.fwd) {
        // The next window's carry-in state, folded alike by every block;
        // rank 0 keeps it in `carry`.
#pragma unroll
        for (int i = 0; i < KM; ++i)
          if (i < K) hc = fmaf(P[i], hc, E[i]);
        if (rank == 0 && valid)
          a.carry[(k.b * a.W + k.w + 1) * DN + state] = hc;
      } else {
        float hin = k.w == 0 ? h0v
                             : (valid ? a.carry[(k.b * a.W + k.w) * DN + state]
                                      : 0.f);
        float qin = qc;
#pragma unroll
        for (int i = 0; i < KM; ++i)
          if (i < rank) hin = fmaf(P[i], hin, E[i]);
#pragma unroll
        for (int i = KM - 1; i >= 0; --i)
          if (i < K && i > rank) qin = fmaf(P[i], qin, Q[i]);
        qc = qin;
#pragma unroll
        for (int i = KM - 1; i >= 0; --i)
          if (i <= rank) qc = fmaf(P[i], qc, Q[i]);
        sCar[j] = hin;
        sCar[G + j] = qin;
        if (k.w == 0 && rank == 0 && valid && a.dh0 != nullptr)
          a.dh0[k.b * DN + state] = qc;
      }
    }
    if (!k.fwd) {
      __syncthreads();
      // This sub-chunk's carries from the chunk's, in the same orders.
      const float hin = sCar[j];
      float hs = hin, qs = sCar[G + j];
      for (int i = 0; i < m; ++i)
        hs = fmaf(sSub[(3 * i) * G + j], hs, sSub[(3 * i + 1) * G + j]);
      for (int i = M - 1; i > m; --i)
        qs = fmaf(sSub[(3 * i) * G + j], qs, sSub[(3 * i + 2) * G + j]);
      // (2) the states from the carry, h_t in Bx's slot.
      auto run2 = [&](int t, int cnt) {
        float av[U], xv[U];
#pragma unroll
        for (int i = 0; i < U; ++i) {
          const bool in = i < cnt;
          av[i] = in ? mA[(t + i) * G] : 1.f;
          xv[i] = in ? mX[(t + i) * G] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < U; ++i) {
          hs = fmaf(av[i], hs, xv[i]);
          if (i < cnt) mX[(t + i) * G] = hs;
        }
      };
      int t = s0;
      for (; t + U <= s1; t += U) run2(t, U);
      if (t < s1) run2(t, s1 - t);
      __syncthreads();
      // The block's sums over its channels of gy_t h_t: a warp a row, each
      // lane over its columns in order, then the lanes of a state n.
      float* pp = a.part + ((k.b * a.nblk + k.grp) * a.S + k.t0) * N;
      const int cols = static_cast<int>(min(static_cast<long long>(G),
                                            DN - k.grp * G));
#pragma unroll 4
      for (int t = warp; t < k.len; t += nthr / 32) {
        float v = 0.f;
        for (int col = lane; col < cols; col += 32)
          v = fmaf(gyc[t * Gc4 + col / N], sX[t * G + col], v);
#pragma unroll
        for (int o = N; o < 32; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
        if (lane < N) pp[t * N + lane] = v;
      }
      const float hb = s0 > 0 ? mX[(s0 - 1) * G] : hin;   // h before s0
      __syncthreads();   // (3) overwrites h with dBx and Abar with dAbar
      // (3) the adjoint from the carry; dBx and dAbar written once, in
      // place for the TMA stores (else straight to device memory).
      const long long row0 = k.b * a.S + k.t0;
      float* pdA = a.dA + row0 * DN + (valid ? state : 0);
      float* pdB = a.dBx + row0 * DN + (valid ? state : 0);
      auto run3 = [&](int t, int cnt) {   // steps t, t - 1, ..., t - cnt + 1
        float av[U], uv[U], hp[U];
#pragma unroll
        for (int i = 0; i < U; ++i) {
          const int s = t - i;
          const bool in = i < cnt;
          av[i] = in ? mA[s * G] : 0.f;
          uv[i] = in ? gyc[s * Gc4 + c] * sC[s * N + n] : 0.f;
          hp[i] = !in ? 0.f : s > s0 ? mX[(s - 1) * G] : hb;
        }
        float* qA = pdA + t * DN;
        float* qB = pdB + t * DN;
#pragma unroll
        for (int i = 0; i < U; ++i) {
          const float g = uv[i] + qs;
          if (i < cnt) {
            if (kTma) {
              mX[(t - i) * G] = g;
              mA[(t - i) * G] = g * hp[i];
            } else if (valid) {
              __stcs(qB - i * DN, g);
              __stcs(qA - i * DN, g * hp[i]);
            }
          }
          qs = av[i] * g;
        }
      };
      t = s1 - 1;
      for (; t - U + 1 >= s0; t -= U) run3(t, U);
      if (t >= s0) run3(t, t - s0 + 1);
      // These writes into a TMA buffer come before the bulk copies that
      // read it (the stores) or overwrite it (the next loads).
      if (kTma) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();
    if (kTma && !k.fwd && tid == 0 && k.len > 0) {
      const int col = static_cast<int>(k.grp * G), t0 = static_cast<int>(k.t0),
                b = static_cast<int>(k.b);
      tma_store(&a.tdA, sA, col, t0, b);
      tma_store(&a.tdB, sX, col, t0, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  cp_async_wait_all();
  if (kTma && tid == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  cluster.sync();   // no block leaves while another may read its (P, e, r)
}

// cuTensorMapEncodeTiled from the driver, found once through the runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
cudaError_t encode_tiled(EncodeTiled* fn) {
  static EncodeTiled found = nullptr;
  if (found == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorNotSupported;
    found = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = found;
  return cudaSuccess;
}

// The map of a (B, S, cols) fp32 tensor in boxes of L steps x w columns.
cudaError_t steps_map(CUtensorMap* map, const float* base, long long B,
                      long long S, long long cols, int L, int w) {
  EncodeTiled fn;
  const cudaError_t err = encode_tiled(&fn);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 4,
                                 static_cast<cuuint64_t>(cols * S) * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(w),
                             static_cast<cuuint32_t>(L), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                        const_cast<float*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The cluster launch of a plan (K, G, smem), the kernel's attributes set
// for it: the dynamic shared memory and a cluster past the portable 8.
template <int N, bool kTma, int GT>
cudaError_t bwd_config(int K, int G, int smem, cudaStream_t st,
                       cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
  const auto kern = scan_bwd_cluster_kernel<N, kTma, GT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(static_cast<unsigned>(K));
  cfg->blockDim = dim3(static_cast<unsigned>(G * kBwdSplit));
  cfg->dynamicSmemBytes = static_cast<size_t>(smem);
  cfg->stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(K);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// The most clusters of a plan's shape the card runs at once (0: refused).
template <int N, bool kTma, int GT>
cudaError_t bwd_clusters_as(int K, int G, int smem, int* clusters) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  const cudaError_t err = bwd_config<N, kTma, GT>(K, G, smem, nullptr, &attr,
                                                  &cfg);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(
      clusters, scan_bwd_cluster_kernel<N, kTma, GT>, &cfg);
}

// Launches scan_bwd_cluster_kernel with the plan (K, L, G, W, smem) of
// scan_bwd_plan, as many clusters as the card runs at once (each walks its
// share of the B * nblk items), then ordered_sum_kernel for dC. Refuses,
// before any launch, a plan that the card cannot co-schedule.
template <int N, bool kTma, int GT>
cudaError_t launch_bwd_as(BwdArgs& a, float* dC, int K, int G, int smem,
                          cudaStream_t st) {
  cudaError_t err;
  if (kTma) {
    const long long DN = a.D * N;
    const float* maps[6] = {a.A, a.Bx, a.gy, a.C, a.dA, a.dBx};
    CUtensorMap* to[6] = {&a.tA, &a.tX, &a.tGy, &a.tC, &a.tdA, &a.tdB};
    const long long cols[6] = {DN, DN, a.D, N, DN, DN};
    const int w[6] = {G, G, bwd_gy_cols(G, N), N, G, G};
    for (int i = 0; i < 6; ++i) {
      err = steps_map(to[i], maps[i], a.B, a.S, cols[i], a.L, w[i]);
      if (err != cudaSuccess) return err;
    }
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  err = bwd_config<N, kTma, GT>(K, G, smem, st, &attr, &cfg);
  if (err != cudaSuccess) return err;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(
      &clusters, scan_bwd_cluster_kernel<N, kTma, GT>, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  const long long items = a.B * a.nblk;
  const long long ncl = clusters < items ? clusters : items;
  cfg.gridDim = dim3(static_cast<unsigned>(ncl * K));
  err = cudaLaunchKernelEx(&cfg, scan_bwd_cluster_kernel<N, kTma, GT>, a);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return ckio::ordered_sum(a.part, dC, a.B, a.nblk, a.S * N, st);
}

// TMA copies where every row of every operand starts 16-byte aligned (D a
// multiple of 4, N >= 4, the inputs and outputs aligned), with the block's
// states fixed at compile time; else cp.async, the states at run time.
template <int N>
bool bwd_tma(const BwdArgs& a) {
  const void* ptrs[6] = {a.A, a.Bx, a.gy, a.C, a.dA, a.dBx};
  bool tma = a.D % 4 == 0 && N >= 4;
  for (const void* q : ptrs)
    tma = tma && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  return tma;
}

template <int N>
cudaError_t launch_bwd(BwdArgs& a, float* dC, int K, int G, int smem,
                       cudaStream_t st) {
  if (G < 32 || G > kBwdMaxStates || G % 32 != 0 || K < 1 ||
      K > kBwdMaxCluster || a.L < 1 || a.L > kBwdMaxChunk || a.W < 1 ||
      static_cast<long long>(K) * a.L * a.W < a.S ||
      4 * bwd_smem_floats(G, a.L, N) > smem ||
      static_cast<long long>(a.nblk) * G < a.D * N || a.B * a.S > INT_MAX ||
      a.D * N > INT_MAX)
    return cudaErrorInvalidValue;
  if constexpr (N >= 4) {
    if (bwd_tma<N>(a)) {
      switch (G) {
        case 32: return launch_bwd_as<N, true, 32>(a, dC, K, G, smem, st);
        case 64: return launch_bwd_as<N, true, 64>(a, dC, K, G, smem, st);
        case 96: return launch_bwd_as<N, true, 96>(a, dC, K, G, smem, st);
        default: return launch_bwd_as<N, true, 128>(a, dC, K, G, smem, st);
      }
    }
  }
  return launch_bwd_as<N, false, 0>(a, dC, K, G, smem, st);
}

// The clusters of the kernel that a plan with aligned operands launches.
template <int N>
cudaError_t bwd_clusters(int K, int G, int smem, int* clusters) {
  if (G < 32 || G > kBwdMaxStates || G % 32 != 0)
    return cudaErrorInvalidValue;
  if constexpr (N >= 4) {
    switch (G) {
      case 32: return bwd_clusters_as<N, true, 32>(K, G, smem, clusters);
      case 64: return bwd_clusters_as<N, true, 64>(K, G, smem, clusters);
      case 96: return bwd_clusters_as<N, true, 96>(K, G, smem, clusters);
      default: return bwd_clusters_as<N, true, 128>(K, G, smem, clusters);
    }
  }
  return bwd_clusters_as<N, false, 0>(K, G, smem, clusters);
}

}  // namespace

// The literal scan's gradient. gy: (B,S,D); A, Bx: (B,S,D,N); C: (B,S,N);
// h0: (B,D,N) or null; all fp32, contiguous. Writes dA, dBx (B,S,D,N), dC
// (B,S,N) and, when dh0 is not null, dh0 (B,D,N). The plan (scan_bwd_plan):
// a cluster of K blocks of G states, chunks of L steps, W windows, smem
// bytes of shared memory a block, nblk = ceil(D*N/G) groups. Scratch
// (floats): part B*nblk*S*N; carry B*W*D*N when W > 1, else unused.
extern "C" int ckio_mamba_scan_backward(
    const float* A, const float* Bx, const float* C, const float* h0,
    const float* gy, float* dA, float* dBx, float* dC, float* dh0,
    float* part, float* carry, long long B, long long S, long long D, int N,
    int K, int L, int G, int W, int nblk, int smem, void* stream) {
  if (B < 1 || S < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (W > 1 && carry == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{};
  a.A = A; a.Bx = Bx; a.C = C; a.h0 = h0; a.gy = gy; a.dA = dA; a.dBx = dBx;
  a.part = part; a.dh0 = dh0; a.carry = carry; a.B = B; a.S = S; a.D = D;
  a.L = L; a.W = W; a.nblk = nblk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (N) {
#define CKIO_BWD(n)                                                \
  case n:                                                          \
    err = launch_bwd<n>(a, dC, K, G, smem, st);                    \
    break;
    CKIO_BWD(1) CKIO_BWD(2) CKIO_BWD(4) CKIO_BWD(8) CKIO_BWD(16) CKIO_BWD(32)
#undef CKIO_BWD
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// How many clusters of K blocks of G threads with smem bytes each the card
// runs at once, in *clusters (0: it refuses the shape).
extern "C" int ckio_mamba_scan_backward_clusters(int N, int K, int G, int smem,
                                                 int* clusters) {
  cudaError_t err;
  switch (N) {
#define CKIO_BWD(n)                                                \
  case n:                                                          \
    err = bwd_clusters<n>(K, G, smem, clusters);                   \
    break;
    CKIO_BWD(1) CKIO_BWD(2) CKIO_BWD(4) CKIO_BWD(8) CKIO_BWD(16) CKIO_BWD(32)
#undef CKIO_BWD
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
