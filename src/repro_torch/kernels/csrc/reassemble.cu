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
//   Bound: bytes. It moves B*(S+1) input tokens and 2*B*S output tokens and
//   does no arithmetic, so its floor is those bytes / 3.35 TB/s. Design:
//   each block copies one row tile of the source into shared memory once,
//   with 16-byte loads wherever a 4-token group lies in one chunk on a
//   16-byte boundary (scalar at chunk and window edges), then writes both
//   outputs from shared memory with 16-byte stores where the rows are
//   16-byte aligned. Each source token is read from device memory once,
//   though it feeds two outputs.
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
//   (the index rows, the gathered tokens and the two outputs). Design: one
//   thread per output token reading device memory directly, so the staged
//   buffer has no size bound (the Pallas version keeps it resident in VMEM).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWindowThreads = 128;
constexpr int kWindowTile = 1024;        // output columns per block
constexpr int kRowThreads = 256;
constexpr long long kRowSliceBytes = 16384;
constexpr int kTokenThreads = 256;

// Largest c in [0, n) with starts[c] <= p (starts is ascending, starts[0]=0).
__device__ __forceinline__ int find_chunk(const long long* __restrict__ starts,
                                          int n, long long p) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(starts + mid) <= p) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ int32_t token_at(const int32_t* const* __restrict__ ptrs,
                                            const long long* __restrict__ starts,
                                            int n, long long p, long long limit,
                                            int32_t pad) {
  if (p >= limit) return pad;
  const int c = find_chunk(starts, n, p);
  return __ldg(ptrs[c] + (p - __ldg(starts + c)));
}

__global__ void __launch_bounds__(kWindowThreads)
window_kernel(const int32_t* const* __restrict__ ptrs,
              const long long* __restrict__ starts, int n_chunks,
              long long limit, int32_t* __restrict__ inputs,
              int32_t* __restrict__ labels, int S, long long w0, int32_t pad) {
  // sm[h + k] holds the token at source position p0 + k, k in [0, T].
  __shared__ __align__(16) int32_t sm[kWindowTile + 8];
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kWindowTile;
  const int T = min(kWindowTile, S - t0);
  const long long p0 = w0 + (long long)b * (S + 1) + t0;
  const int h = (int)(p0 & 3);
  const long long q0 = p0 - h;                 // a multiple of 4
  const int ngroups = (h + T + 1 + 3) >> 2;

  for (int g = threadIdx.x; g < ngroups; g += blockDim.x) {
    const long long q = q0 + 4LL * g;
    bool done = false;
    if (q + 4 <= limit) {
      const int c = find_chunk(starts, n_chunks, q);
      const long long c0 = __ldg(starts + c);
      if (q + 4 <= __ldg(starts + c + 1)) {
        const int32_t* src = ptrs[c] + (q - c0);
        if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
          *reinterpret_cast<int4*>(sm + 4 * g) =
              __ldg(reinterpret_cast<const int4*>(src));
          done = true;
        }
      }
    }
    if (!done) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sm[4 * g + e] = token_at(ptrs, starts, n_chunks, q + e, limit, pad);
    }
  }
  __syncthreads();

  int32_t* in_row = inputs + (long long)b * S + t0;
  int32_t* lb_row = labels + (long long)b * S + t0;
  int j0 = 0;
  if (((reinterpret_cast<uintptr_t>(in_row) |
        reinterpret_cast<uintptr_t>(lb_row)) & 15) == 0) {
    const int nv = T >> 2;
    for (int v = threadIdx.x; v < nv; v += blockDim.x) {
      const int k = h + 4 * v;
      const int4 a = make_int4(sm[k], sm[k + 1], sm[k + 2], sm[k + 3]);
      const int4 l = make_int4(sm[k + 1], sm[k + 2], sm[k + 3], sm[k + 4]);
      *reinterpret_cast<int4*>(in_row + 4 * v) = a;
      *reinterpret_cast<int4*>(lb_row + 4 * v) = l;
    }
    j0 = nv * 4;
  }
  for (int j = j0 + threadIdx.x; j < T; j += blockDim.x) {
    in_row[j] = sm[h + j];
    lb_row[j] = sm[h + j + 1];
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

__global__ void __launch_bounds__(kTokenThreads)
tokens_kernel(const int32_t* __restrict__ staged, long long L,
              const int32_t* __restrict__ row_idx, int32_t* __restrict__ inputs,
              int32_t* __restrict__ labels, long long total, int S, int32_t pad) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long b = t / S;
    const int j = (int)(t - b * S);
    const int32_t* r = row_idx + b * (S + 1);
    const long long a = __ldg(r + j);
    const long long c = __ldg(r + j + 1);
    inputs[t] = a >= 0 ? __ldg(staged + min(a, L - 1)) : pad;
    labels[t] = c >= 0 ? __ldg(staged + min(c, L - 1)) : pad;
  }
}

}  // namespace

extern "C" int ckio_reassemble_window(const void* ptrs, const void* starts,
                                      int n_chunks, long long limit,
                                      void* inputs, void* labels, int B, int S,
                                      long long w0, int pad, void* stream) {
  const dim3 grid((S + kWindowTile - 1) / kWindowTile, B);
  window_kernel<<<grid, kWindowThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t* const*>(ptrs),
      static_cast<const long long*>(starts), n_chunks, limit,
      static_cast<int32_t*>(inputs), static_cast<int32_t*>(labels), S, w0,
      static_cast<int32_t>(pad));
  return static_cast<int>(cudaGetLastError());
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
  const long long total = B * S;
  long long blocks = (total + kTokenThreads - 1) / kTokenThreads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;   // grid-stride beyond
  tokens_kernel<<<static_cast<unsigned>(blocks), kTokenThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(staged), L,
      static_cast<const int32_t*>(row_idx), static_cast<int32_t*>(inputs),
      static_cast<int32_t*>(labels), total, S, static_cast<int32_t>(pad));
  return static_cast<int>(cudaGetLastError());
}
