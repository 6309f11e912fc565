// CkIO phase-2 data permutation on an NVIDIA Hopper card (sm_90a).
//
// Three gather kernels with a plain C interface (loaded through ctypes by
// repro_torch/kernels/reassemble.py). Each launcher enqueues on the stream
// it is given, allocates nothing, and returns cudaGetLastError() so that a
// refused launch is reported at the call.
//
// window_kernel — replaces reassemble_window_pallas
//   (src/repro/kernels/reassemble.py, kern1/kern2). File-order tokens, held
//   as a table of chunk pointers plus prefix token offsets (one entry for a
//   whole-window staging, one per splinter when streamed), become
//   batch-major (inputs, labels): row b, column j reads flat position
//   w0 + b*(S+1) + j, labels the same shifted by one; positions at or past
//   min(valid_limit, total) read pad_id. Any w0 is handled.
//   Bound: at the train step's window (B=8, S=2048: 196,640 B, 0.06 us at
//   3.35 TB/s) the launch and the chain of dependent loads before the first
//   store; at a large window, bytes (B*(S+1) tokens read, 2*B*S written,
//   no arithmetic). Design, for the small window: nothing is queued before
//   the kernel, and one global load stands between launch and store. A
//   table of up to kMaxParamChunks entries travels in the kernel's
//   parameters (__grid_constant__, read through the constant cache), so the
//   wrapper makes no host tensor and no copy; a longer one (a 64 MiB window
//   of 16 KiB splinters) is read from device memory by the same kernel,
//   templated on where its table lives. A warp finds the chunk of its span
//   once (a 32-ary search, 32 probes a round, the same on every lane) and
//   reads that chunk's pointer and bounds together; a lane steps forward
//   only where its group lies past them. Each lane loads one 16-byte group
//   of the source into registers; the words that the row's misalignment
//   h = p0 & 3 and the label's extra token need come from the next lane by
//   __shfl_sync (lane 0 loads the group after the warp's span once), so
//   there is no shared-memory stage and no barrier. A group inside one
//   chunk but off a 16-byte boundary is four plain loads; one that
//   straddles a chunk edge or the valid limit is read token by token. Each
//   lane stores both outputs with 16-byte stores where the output rows are
//   aligned (S % 4 == 0). Tiles of 256 columns put the main-path window on
//   64 blocks.
//
// gather_rows_kernel — replaces reassemble_pallas (_gather_kernel).
//   Block gather out[i] = src[idx[i]] over rows of row_bytes bytes; any
//   element type, repeats allowed. Bound: bytes (NBo rows read and written
//   once). Design: one block per (output row, 16 KiB slice of the row),
//   copying in the widest unit (16/4/2/1 bytes) that the row size and both
//   base pointers allow, neighbouring threads on neighbouring addresses.
//
// tokens_kernel — replaces reassemble_tokens_pallas (kern).
//   Token gather: inputs[b,j] = staged[clip(row_idx[b,j])] unless
//   row_idx[b,j] < 0 (then pad_id); labels use column j+1. Bound: bytes
//   (the index rows, each distinct gathered token once, the two outputs)
//   on a map of runs, as CkIO's arrival order gives; on a random map the
//   card's random access to device memory, far above it (each 4-byte
//   gather costs a 32-byte sector at least). Design: a 2-D grid (column
//   tiles, rows), so a block knows its row without a division. A lane
//   takes kTokenColumns columns 32 apart, neighbouring lanes on
//   neighbouring columns, so index loads, gathers from a run and stores
//   are each one 128-byte line a warp, with kTokenColumns gathers in flight
//   a lane. Each staged token is gathered once, as the Pallas kernel takes
//   each row once: the label of column j is column j+1's token, passed from
//   the next lane by __shfl_sync (lane 0 gathers the column after its
//   warp's span for lane 31). The staged buffer has no size bound (the
//   Pallas version keeps it resident in VMEM).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// Tables of up to kMaxParamChunks entries go by value (2,056 B of
// parameters, under the classic 4 KB limit). The wrapper reads the cap
// through ckio_window_param_chunks.
constexpr int kMaxParamChunks = 128;
// Warps a block and the token gather's columns a lane, chosen by timing
// variants with scripts/time_reassemble.py.
constexpr int kWindowWarps = 2;
constexpr int kTokenWarps = 8;
constexpr int kTokenColumns = 4;
constexpr int kRowThreads = 256;
constexpr long long kRowSliceBytes = 16384;

// A chunk table in the kernel's parameters: kMaxParamChunks pointers, then
// kMaxParamChunks + 1 prefix token offsets (entries past the table's
// length are unused).
struct ParamTable {
  const int32_t* ptr[kMaxParamChunks];
  long long start[kMaxParamChunks + 1];
  __device__ __forceinline__ const int32_t* chunk(int c) const { return ptr[c]; }
  __device__ __forceinline__ long long begin(int c) const { return start[c]; }
};

// The same table in device memory: n pointers, then n + 1 offsets.
struct DeviceTable {
  const long long* t;
  int n;
  __device__ __forceinline__ const int32_t* chunk(int c) const {
    return reinterpret_cast<const int32_t*>(__ldg(t + c));
  }
  __device__ __forceinline__ long long begin(int c) const {
    return __ldg(t + n + c);
  }
};

struct WindowArgs {
  long long limit;     // min(valid_limit, total): positions at or past it pad
  long long w0;        // the window's first token in the table
  int32_t* inputs;
  int32_t* labels;
  int B, S, n;         // rows, columns, chunks
  int32_t pad;
  int vec_out;         // output rows 16-byte aligned
};

// Largest c in [0, n) with begin(c) <= q, for a q that every lane of the
// warp holds: each round probes 32 offsets at once and keeps the span
// between the last probe at or below q and the next.
template <class Tab>
__device__ __forceinline__ int warp_find_chunk(const Tab& tab, int n,
                                               long long q) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) >> 5;
    const int k = lo + lane * step;
    const bool le = lane == 0 || (k < hi && tab.begin(k) <= q);
    const int cnt = __popc(__ballot_sync(kFull, le));
    lo += (cnt - 1) * step;
    hi = min(hi, lo + step);
  }
  return lo;
}

// Step c forward to the chunk holding p (p < total = begin(n)).
template <class Tab>
__device__ __forceinline__ void advance(const Tab& tab, int& c, long long p) {
  while (tab.begin(c + 1) <= p) ++c;
}

// Chunk c's tokens [lo, hi) and its pointer, read together.
struct Span {
  const int32_t* ptr;
  long long lo, hi;
};

template <class Tab>
__device__ __forceinline__ Span span_of(const Tab& tab, int c) {
  return Span{tab.chunk(c), tab.begin(c), tab.begin(c + 1)};
}

// Tokens q .. q+3 one at a time, positions at or past the limit padded:
// groups that straddle a chunk edge or the limit.
template <class Tab>
__device__ __forceinline__ int4 load_tokens(const Tab& tab, int c, long long q,
                                            long long limit, int32_t pad) {
  int32_t v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const long long p = q + e;
    if (p < limit) {
      advance(tab, c, p);
      v[e] = __ldg(tab.chunk(c) + (p - tab.begin(c)));
    } else {
      v[e] = pad;
    }
  }
  return make_int4(v[0], v[1], v[2], v[3]);
}

// Tokens q .. q+3 (q a multiple of 4, at or past sp.lo). A group below the
// limit and in one chunk is one 16-byte load on a 16-byte boundary, else
// four plain loads (a chunk whose start is not a multiple of 4 tokens from
// a 16-byte boundary). c and sp step forward to the group's chunk.
template <class Tab>
__device__ __forceinline__ int4 load_group(const Tab& tab, int& c, Span& sp,
                                           long long q, long long limit,
                                           int32_t pad) {
  if (q + 4 <= limit) {
    if (q >= sp.hi) {
      advance(tab, c, q);
      sp = span_of(tab, c);
    }
    if (q + 4 <= sp.hi) {
      const int32_t* src = sp.ptr + (q - sp.lo);
      if ((reinterpret_cast<uintptr_t>(src) & 15) == 0)
        return __ldg(reinterpret_cast<const int4*>(src));
      return make_int4(__ldg(src), __ldg(src + 1), __ldg(src + 2),
                       __ldg(src + 3));
    }
  }
  return load_tokens(tab, c, q, limit, pad);
}

// Words s .. s+3 of the 8 words a ++ b (s in 0..4, the same on every lane).
__device__ __forceinline__ int4 window4(const int4& a, const int4& b, int s) {
  switch (s) {
    case 0: return a;
    case 1: return make_int4(a.y, a.z, a.w, b.x);
    case 2: return make_int4(a.z, a.w, b.x, b.y);
    case 3: return make_int4(a.w, b.x, b.y, b.z);
    default: return b;
  }
}

__device__ __forceinline__ int4 shfl4(const int4& v, int src) {
  return make_int4(__shfl_sync(kFull, v.x, src), __shfl_sync(kFull, v.y, src),
                   __shfl_sync(kFull, v.z, src), __shfl_sync(kFull, v.w, src));
}

__device__ __forceinline__ void store4(int32_t* out, long long o, const int4& v,
                                       int n, bool vec) {
  if (vec && n >= 4) {
    *reinterpret_cast<int4*>(out + o) = v;
    return;
  }
  const int32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < n) out[o + e] = w[e];
}

// Block (x, y) covers columns [x*tile, x*tile + T) of rows y, y + gridDim.y,
// ...; tile = blockDim.x * 4. Thread t holds the source group t (tokens
// q0 + 4t .. +3, q0 = p0 - h) and writes output columns 4t .. 4t+3.
template <class Tab>
__global__ void __launch_bounds__(32 * kWindowWarps)
window_kernel(const __grid_constant__ Tab tab, const WindowArgs a) {
  const int lane = threadIdx.x & 31;
  const int v = threadIdx.x;
  const int t0 = blockIdx.x * blockDim.x * 4;
  const int T = min((int)blockDim.x * 4, a.S - t0);
  const int vneed = ((T - 1) >> 2) + 1;   // groups 0 .. vneed feed an output
  const int j = 4 * v;
  const bool vec = a.vec_out != 0;
  for (int b = blockIdx.y; b < a.B; b += gridDim.y) {
    const long long p0 = a.w0 + (long long)b * (a.S + 1) + t0;
    const int h = (int)(p0 & 3);
    const long long q0 = p0 - h;
    int c = warp_find_chunk(tab, a.n, q0 + 4LL * (v - lane));
    Span sp = span_of(tab, c);
    int4 g = make_int4(0, 0, 0, 0), after = g;
    if (v <= vneed) g = load_group(tab, c, sp, q0 + 4LL * v, a.limit, a.pad);
    // Lane 0 also loads the group after the warp's span, for lane 31.
    if (lane == 0 && v + 32 <= vneed)
      after = load_group(tab, c, sp, q0 + 4LL * (v + 32), a.limit, a.pad);
    const int4 nx = shfl4(lane == 0 ? after : g, (lane + 1) & 31);
    if (j < T) {
      int32_t* in_row = a.inputs + (long long)b * a.S + t0;
      int32_t* lb_row = a.labels + (long long)b * a.S + t0;
      store4(in_row, j, window4(g, nx, h), T - j, vec);
      store4(lb_row, j, window4(g, nx, h + 1), T - j, vec);
    }
  }
}

template <typename U>
__global__ void __launch_bounds__(kRowThreads)
gather_rows_kernel(const char* __restrict__ src, const int32_t* __restrict__ idx,
                   char* __restrict__ out, long long row_bytes) {
  const long long i = blockIdx.x;
  const long long s = __ldg(idx + i);
  const long long lo = (long long)blockIdx.y * kRowSliceBytes;
  const long long hi = min(row_bytes, lo + kRowSliceBytes);
  const U* s_row = reinterpret_cast<const U*>(src + s * row_bytes + lo);
  U* d_row = reinterpret_cast<U*>(out + i * row_bytes + lo);
  const long long n = (hi - lo) / (long long)sizeof(U);
  for (long long k = threadIdx.x; k < n; k += blockDim.x) d_row[k] = s_row[k];
}

struct TokensArgs {
  const int32_t* staged;
  long long L;
  const int32_t* row_idx;   // (B, S+1)
  int32_t* inputs;
  int32_t* labels;
  int B, S;
  int32_t pad;
};

// Block (x, y) covers columns [x*tile, x*tile + T) of rows y, y + gridDim.y,
// ...; tile = blockDim.x * C. Lane l of warp w takes the columns
// w*32C + 32k + l, k < C, and gathers each once; lane 0 also takes the
// column after the warp's span. Index columns past S are never read.
__global__ void __launch_bounds__(32 * kTokenWarps)
tokens_kernel(const TokensArgs a) {
  constexpr int C = kTokenColumns;
  const int lane = threadIdx.x & 31;
  const int t0 = blockIdx.x * blockDim.x * C;
  const int T = min((int)blockDim.x * C, a.S - t0);  // index columns t0 .. t0+T
  const int jw = (threadIdx.x >> 5) * 32 * C;
  for (int b = blockIdx.y; b < a.B; b += gridDim.y) {
    const int32_t* r = a.row_idx + (long long)b * (a.S + 1) + t0;
    int32_t idx[C + 1], v[C + 1];
#pragma unroll
    for (int k = 0; k <= C; ++k) {
      const int j = jw + 32 * k + (k < C ? lane : 0);
      idx[k] = (j <= T && (k < C || lane == 0)) ? __ldg(r + j) : -1;
    }
#pragma unroll
    for (int k = 0; k <= C; ++k)
      v[k] = idx[k] >= 0 ? __ldg(a.staged + min((long long)idx[k], a.L - 1))
                         : a.pad;
    int32_t* in_row = a.inputs + (long long)b * a.S + t0;
    int32_t* lb_row = a.labels + (long long)b * a.S + t0;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      // The label of column j is column j+1's token: lane l+1's, or for
      // lane 31 lane 0's of the next round.
      const int32_t nx = __shfl_sync(kFull, lane == 0 ? v[k + 1] : v[k],
                                     (lane + 1) & 31);
      const int j = jw + 32 * k + lane;
      if (j < T) {
        in_row[j] = v[k];
        lb_row[j] = nx;
      }
    }
  }
}

template <class Tab>
int launch_window(const Tab& tab, const WindowArgs& a, cudaStream_t st) {
  const int threads = 32 * kWindowWarps;
  const int tile = threads * 4;
  const dim3 grid((a.S + tile - 1) / tile, a.B < 65535 ? a.B : 65535);
  window_kernel<Tab><<<grid, threads, 0, st>>>(tab, a);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" int ckio_window_param_chunks() { return kMaxParamChunks; }

// table: n pointers, then n + 1 prefix token offsets, as int64. With
// on_device == 0 a host array, copied into the launch's parameters (n <=
// kMaxParamChunks); otherwise a device array that the kernel reads.
extern "C" int ckio_reassemble_window(const long long* table, int on_device,
                                      int n_chunks, long long limit,
                                      void* inputs, void* labels, int B, int S,
                                      long long w0, int pad, void* stream) {
  if (n_chunks < 1 || B < 1 || S < 1 || w0 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  WindowArgs a;
  a.limit = limit;
  a.w0 = w0;
  a.inputs = static_cast<int32_t*>(inputs);
  a.labels = static_cast<int32_t*>(labels);
  a.B = B;
  a.S = S;
  a.n = n_chunks;
  a.pad = static_cast<int32_t>(pad);
  a.vec_out = S % 4 == 0 && aligned16(inputs) && aligned16(labels);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (on_device) {
    const DeviceTable tab{table, n_chunks};
    return launch_window(tab, a, st);
  }
  if (n_chunks > kMaxParamChunks) return static_cast<int>(cudaErrorInvalidValue);
  ParamTable tab;
  const int n = n_chunks;
  for (int c = 0; c < kMaxParamChunks; ++c) {
    tab.ptr[c] = c < n ? reinterpret_cast<const int32_t*>(table[c]) : nullptr;
    tab.start[c] = table[n + (c < n ? c : n)];   // the total past the table
  }
  tab.start[kMaxParamChunks] = table[2 * n];
  return launch_window(tab, a, st);
}

extern "C" int ckio_reassemble(const void* src, const void* idx, void* out,
                               long long n_out, long long row_bytes, int unit,
                               void* stream) {
  const dim3 grid(static_cast<unsigned>(n_out),
                  static_cast<unsigned>((row_bytes + kRowSliceBytes - 1) /
                                        kRowSliceBytes));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const char* s = static_cast<const char*>(src);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  char* o = static_cast<char*>(out);
  switch (unit) {
    case 16: gather_rows_kernel<int4><<<grid, kRowThreads, 0, st>>>(s, ix, o, row_bytes); break;
    case 4: gather_rows_kernel<int32_t><<<grid, kRowThreads, 0, st>>>(s, ix, o, row_bytes); break;
    case 2: gather_rows_kernel<int16_t><<<grid, kRowThreads, 0, st>>>(s, ix, o, row_bytes); break;
    case 1: gather_rows_kernel<char><<<grid, kRowThreads, 0, st>>>(s, ix, o, row_bytes); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ckio_reassemble_tokens(const void* staged, long long L,
                                      const void* row_idx, void* inputs,
                                      void* labels, long long B, int S, int pad,
                                      void* stream) {
  if (B < 1 || B > 0x7fffffffLL || S < 1 || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  TokensArgs a;
  a.staged = static_cast<const int32_t*>(staged);
  a.L = L;
  a.row_idx = static_cast<const int32_t*>(row_idx);
  a.inputs = static_cast<int32_t*>(inputs);
  a.labels = static_cast<int32_t*>(labels);
  a.B = static_cast<int>(B);
  a.S = S;
  a.pad = static_cast<int32_t>(pad);
  const int threads = 32 * kTokenWarps;
  const int tile = threads * kTokenColumns;
  const dim3 grid((S + tile - 1) / tile,
                  static_cast<unsigned>(B < 65535 ? B : 65535));
  tokens_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
