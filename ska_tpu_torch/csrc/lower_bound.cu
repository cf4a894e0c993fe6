// Lower bound of (M, W) query keys in an (N, W) sorted key table on
// Hopper: out[i] = the number of table rows below query i, in [0, N].
//
// Replaces ska_tpu/ops/keys.py::searchsorted_via_sort (:195), the JAX
// package's lookup for `ska map`. It is no Pallas kernel: it sorts
// [queries; table] with jax.lax.sort and reads the lower bounds off the
// sorted order, because gathers are the TPU's weak spot. The port ran the
// same sort on the radix kernel (radix_sort.cu), 9 scatter passes over
// 10.5 M rows at W=1 and 17 at W=2. Order: the limbs compared as unsigned
// 64-bit words, first limb most significant, so the answers are
// np.searchsorted(side="left") on the 64- or 128-bit keys; no sign bias.
//
// What bounds it: the latency of dependent loads, not bandwidth. A plain
// binary search of 2^21 queries in 2^23 keys makes 23 dependent loads a
// query, into a table (64 MiB at W=1, 128 MiB at W=2) that does not fit
// the 50 MB L2. The bytes the lookup must move (each key and query read
// once, each answer written once) take 0.030 ms at W=1 and 0.055 ms at
// W=2 at 3.35 TB/s; the time goes into waiting on loads. So the design
// takes the upper levels of the search out of device memory and keeps
// as many searches in flight as the SMs hold threads.
//
// Design, two launches a lookup:
// - splitter_kernel copies every stride-th table row into a splitter
//   array (stride = 2^s, the least power of two that leaves at most
//   kSplitterBytes of rows: 16384 splitters at W=1, 8192 at W=2, so
//   s = 9 and 10 for N = 2^23).
// - search_kernel: persistent blocks of kThreads, one per SM (the
//   splitters take 128 KiB of its shared memory), each load the
//   splitters once into dynamic shared memory with cp.async and then
//   walk the queries grid-stride, one a thread each round, loaded
//   coalesced. For each query, a branchless binary lifting over the
//   splitters in shared memory counts the splitters below it (15 steps at
//   W=1, 14 at W=2); that leaves a window of stride - 1 table rows after
//   the last splitter below it, which a branchless lifting of s steps
//   finishes in device memory through the read-only path (__ldg). The
//   answers are stored coalesced as int64.
// - Why these sizes: the shared memory of an SM is also its L1, which
//   holds the rows of the window's first steps. On an H100 at 2^21
//   queries in 2^23 keys (chip_smoke.py phase 2, device time), this
//   shape searches in 0.22 ms at W=1 and 0.37 ms at W=2; a first version
//   with 6 (W=1) or 3 (W=2) blocks of 256 threads per SM, 32 or 64 KiB of
//   splitters each and 4 searches a thread advanced step by step
//   together took 0.53 and 0.47 ms. At 1024 threads a block, overlapping
//   several searches in a thread did not pay.
//
// Plain C interface for ctypes: every function launches on the given
// stream, allocates nothing, does not synchronise, and returns a CUDA
// error code (0 when the launch was accepted). The wrapper,
// ska_tpu_torch/ops/lookup.py, picks the stride and allocates the
// splitters and the answers.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;           // threads per block
constexpr int kSplitterBytes = 1 << 17;  // shared memory for the splitters

// the most splitter rows of W limbs that kSplitterBytes holds
constexpr int max_splitters(int W) { return kSplitterBytes / (8 * W); }

typedef unsigned long long u64;

template <int W>
struct Key {
  u64 v[W];
};

template <int W>
__device__ __forceinline__ bool key_less(const Key<W>& a, const Key<W>& b) {
  if constexpr (W == 1) {
    return a.v[0] < b.v[0];
  } else {
    return a.v[0] < b.v[0] || (a.v[0] == b.v[0] && a.v[1] < b.v[1]);
  }
}

// Row `row` of a (rows, W) key array in device memory, read-only path.
// Each limb is its own 8-byte load, so a view at any int64 offset works.
template <int W>
__device__ __forceinline__ Key<W> load_key(const u64* __restrict__ p,
                                           long long row) {
  Key<W> k;
#pragma unroll
  for (int w = 0; w < W; ++w) k.v[w] = __ldg(p + row * W + w);
  return k;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
    splitter_kernel(const u64* __restrict__ table, int log_stride,
                    int n_splitters, u64* __restrict__ splitters) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_splitters) return;
  const long long row = (long long)i << log_stride;
#pragma unroll
  for (int w = 0; w < W; ++w) splitters[i * W + w] = table[row * W + w];
}

template <int W>
__global__ void __launch_bounds__(kThreads)
    search_kernel(const u64* __restrict__ table, long long n,
                  const u64* __restrict__ splitters, int n_splitters,
                  int log_stride, const u64* __restrict__ queries,
                  long long m, long long* __restrict__ out) {
  extern __shared__ u64 s_split[];  // [n_splitters][W]
  for (int i = threadIdx.x; i < n_splitters * W; i += kThreads) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(s_split + i);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(dst), "l"(splitters + i) : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // the largest power of two <= n_splitters: the first lifting step
  const int top = n_splitters ? 1 << (31 - __clz(n_splitters)) : 0;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < m;
       i += (long long)gridDim.x * kThreads) {
    const Key<W> q = load_key<W>(queries, i);
    // c = the splitters below q: c grows by `step` where splitter
    // c + step - 1 is below q (the splitters ascend, so this is binary
    // lifting over a monotone predicate)
    int c = 0;
    for (int step = top; step > 0; step >>= 1) {
      const int j = c + step;
      const int r = (j <= n_splitters ? j : n_splitters) - 1;
      Key<W> s;
#pragma unroll
      for (int w = 0; w < W; ++w) s.v[w] = s_split[r * W + w];
      c = (j <= n_splitters && key_less(s, q)) ? j : c;
    }
    // lo = the last row known below q: splitter c - 1 (row (c-1)*stride),
    // or -1 where no splitter is; the rows up to the next splitter's are
    // the window, stride - 1 of them, searched by the same lifting
    long long lo = c ? (long long)(c - 1) << log_stride : -1;
    for (long long step = (1LL << log_stride) >> 1; step > 0; step >>= 1) {
      const long long j = lo + step;
      const Key<W> key = load_key<W>(table, j < n ? j : n - 1);
      lo = (j < n && key_less(key, q)) ? j : lo;
    }
    out[i] = lo + 1;
  }
}

}  // namespace

extern "C" {

int ska_lower_bound_splitter_bytes() { return kSplitterBytes; }

// splitters[i] = table row i << log_stride, for i < n_splitters.
int ska_lower_bound_splitters(int W, const void* table, int log_stride,
                              int n_splitters, void* splitters,
                              cudaStream_t stream) {
  if ((W != 1 && W != 2) || n_splitters < 1 || n_splitters > max_splitters(W))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (n_splitters + kThreads - 1) / kThreads;
  if (W == 1) {
    splitter_kernel<1><<<blocks, kThreads, 0, stream>>>(
        (const u64*)table, log_stride, n_splitters, (u64*)splitters);
  } else {
    splitter_kernel<2><<<blocks, kThreads, 0, stream>>>(
        (const u64*)table, log_stride, n_splitters, (u64*)splitters);
  }
  return (int)cudaGetLastError();
}

// out[i] = lower bound of query i (m >= 1) in the n table rows, given
// the n_splitters splitters of ska_lower_bound_splitters (none when
// n == 0). Launches as many blocks as fit the current device's SMs.
int ska_lower_bound_search(int W, const void* table, long long n,
                           const void* splitters, int n_splitters,
                           int log_stride, const void* queries, long long m,
                           void* out, cudaStream_t stream) {
  if ((W != 1 && W != 2) || n_splitters < 0 || n_splitters > max_splitters(W)
      || m < 1)
    return (int)cudaErrorInvalidValue;
  auto kernel = W == 1 ? &search_kernel<1> : &search_kernel<2>;
  const int smem = n_splitters * W * (int)sizeof(u64);
  int dev, sms, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const long long rounds = (m + kThreads - 1) / kThreads;
  long long blocks = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (blocks > rounds) blocks = rounds;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const u64*)table, n, (const u64*)splitters, n_splitters, log_stride,
      (const u64*)queries, m, (long long*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
