// Bitonic sort of (key limbs, int32 key, uint8 payload) rows on Hopper.
//
// Replaces ska_tpu/ops/sort.py::_window_kernel_body / _window_call, the
// TPU Pallas kernel that runs every bitonic compare-exchange stage below a
// VMEM window, plus the _ce_jnp passes between its calls. The port's
// merged build (ska_tpu_torch/ops/pipeline.py) runs it as the one global
// sort by (split k-mer key, sample id) that carries the IUPAC set.
//
// The network is the JAX one: for stage mm = 1..log2(L) and stride
// j = mm-1..0, element i meets i ^ 2^j; the direction is bit mm of i (its
// index within its row); a pair swaps only when the upper element is
// strictly below the lower one (descending: when it is not). Ties are not
// kept in order, so the sort is unstable.
//
// Unlike the TPU kernel, key limbs are read straight from the int64
// storage as unsigned 64-bit words: the card compares 64 bits natively,
// so there is no split into biased 32-bit planes, and no lane-major
// element order (a TPU register artifact).
//
// What bounds it: device-memory bandwidth. The network has
// log2(N)*(log2(N)+1)/2 compare-exchange passes, 325 at N = 2^25, over
// 8W+5 bytes per element. The tile kernel exists to keep the small
// strides out of device memory: one block holds a tile of T = 2^11
// elements in shared memory and runs every stride below T there, so only
// strides >= T go through device memory, one global_kernel pass each. At
// N = 2^25 that is 105 global passes and 15 tile launches (the first runs
// stages 1..11 whole, each later one the low strides of one stage).
//
// Plain C interface for ctypes: every function launches on the given
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (0 when the launch was accepted). The launch plan
// (which stages and strides each launch runs) is made by the Python
// wrapper, ska_tpu_torch/ops/sort.py::_bitonic_plan.

#include <cuda_runtime.h>

namespace {

constexpr int kTileLogMax = 11;
constexpr int kTileMax = 1 << kTileLogMax;  // 43 KB of shared memory at W=2
constexpr int kGlobalThreads = 256;

template <int W>
struct Rows {
  unsigned long long* key[W];
  int* sid;
  unsigned char* set;
};

template <int W>
Rows<W> make_rows(const void* k0, const void* k1, const void* sid,
                  const void* set) {
  Rows<W> r;
  r.key[0] = (unsigned long long*)k0;
  if constexpr (W == 2) r.key[1] = (unsigned long long*)k1;
  r.sid = (int*)sid;
  r.set = (unsigned char*)set;
  return r;
}

// (x, xs) < (y, ys): limbs unsigned, hi limb first, then the int32 key
template <int W>
__device__ __forceinline__ bool row_less(const unsigned long long* x, int xs,
                                         const unsigned long long* y, int ys) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    if (x[w] != y[w]) return x[w] < y[w];
  }
  return xs < ys;
}

// One block per tile of T = 2^tlog rows (T/2 threads, one pair each).
// Runs stages mm_lo..mm_hi, each over its strides below T. For mm > tlog
// the direction is a bit above the tile, the same for the whole tile.
// Reads `in`, writes `out` (the same rows after the first launch).
template <int W>
__global__ void __launch_bounds__(kTileMax / 2)
tile_kernel(Rows<W> in, Rows<W> out, long long L, int tlog, int mm_lo,
            int mm_hi) {
  __shared__ unsigned long long sk[W][kTileMax];
  __shared__ int ss[kTileMax];
  __shared__ unsigned char sp[kTileMax];

  const int T = 1 << tlog;
  const long long base = (long long)blockIdx.x << tlog;
  const long long row_base = base & (L - 1);  // tile start within its row
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
#pragma unroll
    for (int w = 0; w < W; ++w) sk[w][i] = in.key[w][base + i];
    ss[i] = in.sid[base + i];
    sp[i] = in.set[base + i];
  }
  __syncthreads();

  const int p = threadIdx.x;
  for (int mm = mm_lo; mm <= mm_hi; ++mm) {
    for (int j = min(mm, tlog) - 1; j >= 0; --j) {
      const int lo = ((p >> j) << (j + 1)) | (p & ((1 << j) - 1));
      const int hi = lo | (1 << j);
      const bool desc = ((row_base + lo) >> mm) & 1;
      unsigned long long a[W], b[W];
#pragma unroll
      for (int w = 0; w < W; ++w) {
        a[w] = sk[w][lo];
        b[w] = sk[w][hi];
      }
      const int sa = ss[lo], sb = ss[hi];
      if (row_less<W>(b, sb, a, sa) != desc) {
#pragma unroll
        for (int w = 0; w < W; ++w) {
          sk[w][lo] = b[w];
          sk[w][hi] = a[w];
        }
        ss[lo] = sb;
        ss[hi] = sa;
        const unsigned char t = sp[lo];
        sp[lo] = sp[hi];
        sp[hi] = t;
      }
      __syncthreads();
    }
  }

  for (int i = threadIdx.x; i < T; i += blockDim.x) {
#pragma unroll
    for (int w = 0; w < W; ++w) out.key[w][base + i] = sk[w][i];
    out.sid[base + i] = ss[i];
    out.set[base + i] = sp[i];
  }
}

// One thread per pair: the compare-exchange of stage mm at stride 2^j
// (j >= the tile size), in place in device memory.
template <int W>
__global__ void global_kernel(Rows<W> io, long long n_pairs, long long L,
                              int mm, int j) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pairs) return;
  const long long lo = ((p >> j) << (j + 1)) | (p & ((1LL << j) - 1));
  const long long hi = lo | (1LL << j);
  const bool desc = ((lo & (L - 1)) >> mm) & 1;
  unsigned long long a[W], b[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    a[w] = io.key[w][lo];
    b[w] = io.key[w][hi];
  }
  const int sa = io.sid[lo], sb = io.sid[hi];
  if (row_less<W>(b, sb, a, sa) != desc) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      io.key[w][lo] = b[w];
      io.key[w][hi] = a[w];
    }
    io.sid[lo] = sb;
    io.sid[hi] = sa;
    const unsigned char t = io.set[lo];
    io.set[lo] = io.set[hi];
    io.set[hi] = t;
  }
}

bool pow2(long long x) { return x > 0 && (x & (x - 1)) == 0; }

}  // namespace

// Rows are `total` elements: total / L rows of L (a power of two) each.
extern "C" int ska_bitonic_tile(int W, const void* in_k0, const void* in_k1,
                                const void* in_sid, const void* in_set,
                                void* k0, void* k1, void* sid, void* set,
                                long long total, long long L, int tlog,
                                int mm_lo, int mm_hi, void* stream) {
  if (tlog < 1 || tlog > kTileLogMax || !pow2(L) || L < (1LL << tlog) ||
      total % L != 0 || mm_lo < 1 || mm_hi < mm_lo)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(total >> tlog)), block(1u << (tlog - 1));
  cudaStream_t s = (cudaStream_t)stream;
  if (W == 1)
    tile_kernel<1><<<grid, block, 0, s>>>(
        make_rows<1>(in_k0, in_k1, in_sid, in_set),
        make_rows<1>(k0, k1, sid, set), L, tlog, mm_lo, mm_hi);
  else if (W == 2)
    tile_kernel<2><<<grid, block, 0, s>>>(
        make_rows<2>(in_k0, in_k1, in_sid, in_set),
        make_rows<2>(k0, k1, sid, set), L, tlog, mm_lo, mm_hi);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int ska_bitonic_global(int W, void* k0, void* k1, void* sid,
                                  void* set, long long total, long long L,
                                  int mm, int j, void* stream) {
  if (!pow2(L) || total % L != 0 || j < 0 || (1LL << (j + 1)) > L || mm <= j)
    return (int)cudaErrorInvalidValue;
  const long long n_pairs = total / 2;
  const dim3 grid((unsigned)((n_pairs + kGlobalThreads - 1) / kGlobalThreads));
  cudaStream_t s = (cudaStream_t)stream;
  if (W == 1)
    global_kernel<1><<<grid, kGlobalThreads, 0, s>>>(
        make_rows<1>(k0, k1, sid, set), n_pairs, L, mm, j);
  else if (W == 2)
    global_kernel<2><<<grid, kGlobalThreads, 0, s>>>(
        make_rows<2>(k0, k1, sid, set), n_pairs, L, mm, j);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
