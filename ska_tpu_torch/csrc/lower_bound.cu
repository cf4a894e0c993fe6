// Lower bound of (M, W) query keys in an (N, W) sorted key table on
// Hopper: out[i] = the number of table rows below query i, in [0, N].
//
// Replaces ska_tpu/ops/keys.py::searchsorted_via_sort (:195), the JAX
// package's lookup for `ska map`. It is no Pallas kernel: it sorts
// [queries; table] with jax.lax.sort and reads the lower bounds off the
// sorted order, because gathers are the TPU's weak spot. Order: the limbs
// compared as unsigned 64-bit words, first limb most significant, so the
// answers are np.searchsorted(side="left") on the 64- or 128-bit keys; no
// sign bias.
//
// What bounds it. The bytes the lookup must move (each key and query read
// once, each answer written once) take 0.025-0.055 ms at map's shapes at
// 3.35 TB/s, but a search reads the table at random: what costs is the
// number of dependent round trips to L2 or device memory a query waits
// on, and the lines (L1 wavefronts, L2 and DRAM sectors) each one moves.
// A plain binary search of 2^21 queries in 2^23 keys makes 23 dependent
// 8-byte loads a query, each in another 32-byte sector. This kernel makes
// 2 or 3 dependent round trips below shared memory (W=1 up to 2^23 keys:
// 2; W=2 at 2^22 and 2^23: 3), each reading whole 128-byte lines.
//
// Design: a B-tree of 128-byte nodes over the table, built per lookup.
// - Levels. A line holds R = 16 rows at W=1, 8 at W=2. Level l (l >= 1)
//   is the array of table rows 0, R^l, 2R^l, ... (every 16th row, every
//   256th, ...; level 1 at k31.skf's 6,447,824 keys is 3.2 MB, so it
//   stays in the 50 MB L2); level 0 is the table itself. The splitters,
//   every 2^shift-th row with 2^shift = R^(L+1) * f, sit above level L
//   in shared memory.
// - The plan (ops/lookup.py plan, the same arithmetic): the least L, and
//   then the least f in {1, 2}, that leave at most kSplitterBytes of
//   splitters (16,384 at W=1, 8,192 at W=2). So the top level read from
//   L2 is f lines (two at once, for one round trip), every level below
//   it one line.
// - levels_kernel (launch 1) reads every R-th table row once and writes
//   it to the splitters and to each level it belongs to. Each array
//   starts on a line of the one buffer the wrapper allocates.
// - search_kernel (launch 2): persistent blocks, one an SM, load the
//   splitters into shared memory with cp.async. Each thread owns one
//   query: a branchless binary lifting over the splitters (15 steps at
//   most) finds c, the splitters below it. Splitter c - 1 is a row below
//   the query (no splitter below: the answer is 0). From that row down,
//   each level's window is the f lines (top) or the one line of entries
//   that start there, and the count of entries below the query moves
//   the known row to the last of them: row += (count - 1) * R^l. At
//   level 0 the answer is that row + the count.
// - A line is read by a team of 8 lanes, 16 bytes each (ulonglong2),
//   so one warp instruction moves four whole lines. In each of 8 rounds
//   the teams take the lines of 4 of the warp's 32 queries (query and
//   window start by shuffle); all 8 rounds' loads are issued before
//   any compare, and the compares go to __ballot_sync, from which each
//   query's lane counts the bits of its team. Entries past a level's
//   end (or past the window's valid count) read as all-ones, which
//   are below no query, and are never loaded. Whole warps run the loop
//   together, the tail's lanes with no query.
// - Alignment: the levels and splitters are aligned by the wrapper.
//   The table may be a view at any int64 offset (distributed_lookup
//   searches a row block), so its lines are counted from the view's
//   start, and when the view is not 16-byte aligned a lane reads its 16
//   bytes as two 8-byte loads; one route, a flag uniform over the launch.
// - The launch plan is fixed, for every N: 1024 threads a block,
//   __launch_bounds__(1024, 1), so ptxas may take up to 64 registers a
//   thread (the 8 rounds' lines are 32 of them) and exactly one block
//   fits an SM; as many blocks as the card has SMs (fewer for fewer
//   than that many warps of queries); dynamic shared memory up to
//   kSplitterBytes and a shared/L1 carveout that holds it, both set once
//   a device (ska_lower_bound_prepare) and not per call. A smaller table
//   takes fewer splitters but the same occupancy. An earlier design let
//   the occupancy API choose, which gave two blocks an SM whenever the
//   splitters were under ~113 KB (4.2-7.3 M keys at W=1), a band where
//   it lost to torch.searchsorted 1.5-1.8x.
// - ptxas (-Xptxas -v, CUDA 12.8, sm_90a): search_kernel 64 registers at
//   both W, with 40 bytes of spill stores and 44 of loads (24-byte
//   stack) at W=1, 64 and 80 (40-byte stack) at W=2, no static shared
//   memory (the splitters are dynamic, n_split * 8W bytes); levels_kernel
//   32 registers, no spills. The spills are the price of issuing all 8
//   rounds' loads at once within the 64 registers of one 1024-thread
//   block an SM.
//
// Plain C interface for ctypes: the launches go on the given stream,
// allocate nothing, do not synchronise, and return a CUDA error code (0
// when both launches were accepted). The wrapper, ska_tpu_torch/ops/
// lookup.py, computes the plan, allocates the buffer and the answers and
// caches the per-device setup.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;           // search threads a block, one block an SM
constexpr int kSplitterBytes = 1 << 17;  // shared memory for the splitters
constexpr int kLineBytes = 128;          // one node of the levels
constexpr int kTeam = kLineBytes / 16;   // lanes that read one line, 16 bytes each
constexpr int kTeams = 32 / kTeam;       // lines one warp instruction reads
constexpr unsigned kTeamMask = (1u << kTeam) - 1;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBuildThreads = 256;
// the smallest carveout, in percent of the 228 KB of an H100 SM, that
// holds the splitters and the 1 KB the runtime keeps a block
constexpr int kCarveout = ((kSplitterBytes + 1024) * 100 + 228 * 1024 - 1)
                          / (228 * 1024);
static_assert(kTeam >= 1 && kTeam < 32 && 32 % kTeam == 0, "team size");

typedef unsigned long long u64;
constexpr u64 kOnes = ~0ULL;

// the most splitter rows of W limbs that kSplitterBytes holds
__host__ __device__ constexpr int max_splitters(int W) {
  return kSplitterBytes / (8 * W);
}
// rows of W limbs in a line, and log2 of a power of two
__host__ __device__ constexpr int line_rows(int W) {
  return kLineBytes / (8 * W);
}
__host__ __device__ constexpr int log2i(int x) {
  return x > 1 ? 1 + log2i(x / 2) : 0;
}

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

// ceil(x / 2^s) for 0 <= x < 2^62
__host__ __device__ __forceinline__ long long ceil_shift(long long x, int s) {
  return (x + (1LL << s) - 1) >> s;
}

// x rounded up to whole lines of R rows
__host__ __device__ __forceinline__ long long pad_rows(long long x, int R) {
  return (x + R - 1) / R * R;
}

template <int W>
__global__ void __launch_bounds__(kBuildThreads)
    levels_kernel(const u64* __restrict__ table, long long n,
                  u64* __restrict__ buf, int levels, int shift,
                  int n_split) {
  constexpr int R = line_rows(W), r = log2i(R);
  const long long rows = ceil_shift(n, r);  // rows 0, R, 2R, ... below n
  for (long long j = (long long)blockIdx.x * kBuildThreads + threadIdx.x;
       j < rows; j += (long long)gridDim.x * kBuildThreads) {
    const long long row = j << r;
    u64 k[W];
#pragma unroll
    for (int w = 0; w < W; ++w) k[w] = table[row * W + w];
    if ((row & ((1LL << shift) - 1)) == 0) {
#pragma unroll
      for (int w = 0; w < W; ++w) buf[(row >> shift) * W + w] = k[w];
    }
    long long off = pad_rows(n_split, R);  // level `levels` starts here
    for (int l = levels; l >= 1; --l) {
      const int s = r * l;
      if ((row & ((1LL << s) - 1)) == 0) {
#pragma unroll
        for (int w = 0; w < W; ++w) buf[(off + (row >> s)) * W + w] = k[w];
      }
      off += pad_rows(ceil_shift(n, s), R);
    }
  }
}

// 16 bytes of a line from p on, of which `avail` entries are valid:
// two keys at W=1, one at W=2; the invalid ones are all-ones and not read
template <int W>
__device__ __forceinline__ ulonglong2 load_part(const u64* __restrict__ p,
                                                int avail, bool aligned) {
  ulonglong2 v = make_ulonglong2(kOnes, kOnes);
  if (avail >= 2 / W) {
    if (aligned) {
      v = __ldg(reinterpret_cast<const ulonglong2*>(p));
    } else {
      v.x = __ldg(p);
      v.y = __ldg(p + 1);
    }
  } else if (avail > 0) {  // W=1, the window's last key
    v.x = __ldg(p);
  }
  return v;
}

// The number of entries below this lane's query q among the `valid`
// entries of `arr` from entry `first` on (a window of `lines` lines),
// counted for every lane of the warp at once: the warp's 32 windows are
// read by teams of kTeam lanes, kTeams windows at a time.
template <int W>
__device__ __forceinline__ int count_below(const u64* __restrict__ arr,
                                           long long first, int valid,
                                           const Key<W>& q, int lines,
                                           bool aligned, int lane) {
  constexpr int R = line_rows(W), per = 2 / W;
  const int team = lane / kTeam;
  const int e_lane = (lane % kTeam) * per;  // this lane's entry in a line
  const int shift_own = (lane % kTeams) * kTeam;  // the owner's team bits
  int count = 0;
  for (int k = 0; k < lines; ++k) {
    const int e0 = k * R + e_lane;
    ulonglong2 v[kTeam];
#pragma unroll
    for (int rd = 0; rd < kTeam; ++rd) {  // issue every round's load first
      const int src = rd * kTeams + team;
      const long long f = __shfl_sync(kFull, first, src);
      const int avail = __shfl_sync(kFull, valid, src) - e0;
      v[rd] = load_part<W>(arr + (f + e0) * W, avail, aligned);
    }
#pragma unroll
    for (int rd = 0; rd < kTeam; ++rd) {
      const int src = rd * kTeams + team;
      Key<W> sq;
#pragma unroll
      for (int w = 0; w < W; ++w) sq.v[w] = __shfl_sync(kFull, q.v[w], src);
      int n_below;
      if constexpr (W == 1) {
        const unsigned b0 = __ballot_sync(kFull, v[rd].x < sq.v[0]);
        const unsigned b1 = __ballot_sync(kFull, v[rd].y < sq.v[0]);
        n_below = __popc((b0 >> shift_own) & kTeamMask)
                  + __popc((b1 >> shift_own) & kTeamMask);
      } else {
        const Key<2> key = {{v[rd].x, v[rd].y}};
        const unsigned b = __ballot_sync(kFull, key_less(key, sq));
        n_below = __popc((b >> shift_own) & kTeamMask);
      }
      if (lane / kTeams == rd) count += n_below;  // this lane's own round
    }
  }
  return count;
}

template <int W>
__global__ void __launch_bounds__(kThreads, 1)
    search_kernel(const u64* __restrict__ table, long long n,
                  const u64* __restrict__ buf, int levels, int log_lines,
                  int n_split, const u64* __restrict__ queries, long long m,
                  long long* __restrict__ out) {
  constexpr int R = line_rows(W), r = log2i(R);
  extern __shared__ u64 s_split[];  // [n_split][W]
  for (int i = threadIdx.x; i < n_split * W; i += kThreads) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(s_split + i);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(dst), "l"(buf + i) : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const bool aligned = (reinterpret_cast<uintptr_t>(table) & 15) == 0;
  const int lane = threadIdx.x & 31;
  const int shift = r * (levels + 1) + log_lines;
  // the largest power of two <= n_split: the first lifting step
  const int top = n_split ? 1 << (31 - __clz(n_split)) : 0;
  // whole warps walk the queries, so that every lane takes part in the
  // shuffles and ballots
  for (long long w0 = (long long)blockIdx.x * kThreads + (threadIdx.x - lane);
       w0 < m; w0 += (long long)gridDim.x * kThreads) {
    const long long i = w0 + lane;
    const bool live = i < m;
    Key<W> q;
#pragma unroll
    for (int w = 0; w < W; ++w) q.v[w] = live ? __ldg(queries + i * W + w) : 0;
    // c = the splitters below q: c grows by `step` where splitter
    // c + step - 1 is below q (binary lifting over a monotone predicate)
    int c = 0;
    for (int step = top; step > 0; step >>= 1) {
      const int j = c + step;
      const int s = (j <= n_split ? j : n_split) - 1;
      Key<W> key;
#pragma unroll
      for (int w = 0; w < W; ++w) key.v[w] = s_split[s * W + w];
      c = (j <= n_split && key_less(key, q)) ? j : c;
    }
    const bool searching = live && c > 0;
    // row: the last row known below q, splitter c - 1's
    long long row = searching ? (long long)(c - 1) << shift : 0;
    long long off = pad_rows(n_split, R);  // level `levels` starts here
    for (int l = levels; l >= 0; --l) {
      const int s = r * l;
      const long long len = ceil_shift(n, s);  // entries of level l
      const long long first = row >> s;        // the window's first entry
      const int lines = l == levels ? 1 << log_lines : 1;
      const long long room = len - first;
      const int valid = !searching ? 0
                        : room < (long long)lines * R ? (int)room
                                                       : lines * R;
      const int below = count_below<W>(l ? buf + off * W : table, first,
                                       valid, q, lines, l ? true : aligned,
                                       lane);
      if (searching) row += (long long)(below - 1) << s;
      if (l) off += pad_rows(len, R);
    }
    if (live) out[i] = searching ? row + 1 : 0;
  }
}

}  // namespace

extern "C" {

int ska_lower_bound_splitter_bytes() { return kSplitterBytes; }
int ska_lower_bound_line_bytes() { return kLineBytes; }
int ska_lower_bound_threads() { return kThreads; }

// Once a device (the current one) and process: let the search kernels
// take kSplitterBytes of dynamic shared memory, and give them and the
// levels kernels the carveout that holds it (one shared/L1 split for
// both launches of a lookup).
int ska_lower_bound_prepare() {
  const void* search[2] = {(const void*)&search_kernel<1>,
                           (const void*)&search_kernel<2>};
  const void* all[4] = {search[0], search[1], (const void*)&levels_kernel<1>,
                        (const void*)&levels_kernel<2>};
  for (const void* k : search) {
    const cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSplitterBytes);
    if (err != cudaSuccess) return (int)err;
  }
  for (const void* k : all) {
    const cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributePreferredSharedMemoryCarveout, kCarveout);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// out[i] = lower bound of query i (m >= 1) in the n table rows, by the
// plan (levels, log_lines, n_split) of ops/lookup.py plan; buf holds its
// splitters and levels (none when n == 0: the search launch alone).
// `blocks` search blocks, at most one an SM.
int ska_lower_bound(int W, const void* table, long long n, void* buf,
                    int levels, int log_lines, int n_split,
                    const void* queries, long long m, void* out, int blocks,
                    cudaStream_t stream) {
  if ((W != 1 && W != 2) || n < 0 || m < 1 || blocks < 1 || levels < 0
      || (log_lines != 0 && log_lines != 1) || n_split < 0
      || n_split > max_splitters(W) || (n_split == 0) != (n == 0))
    return (int)cudaErrorInvalidValue;
  const int shift = log2i(line_rows(W)) * (levels + 1) + log_lines;
  if (shift > 62 || ceil_shift(n, shift) != n_split)
    return (int)cudaErrorInvalidValue;
  if (n_split) {
    const long long rows = ceil_shift(n, log2i(line_rows(W)));
    long long grid = (rows + kBuildThreads - 1) / kBuildThreads;
    if (grid > (1 << 20)) grid = 1 << 20;
    if (W == 1) {
      levels_kernel<1><<<(unsigned)grid, kBuildThreads, 0, stream>>>(
          (const u64*)table, n, (u64*)buf, levels, shift, n_split);
    } else {
      levels_kernel<2><<<(unsigned)grid, kBuildThreads, 0, stream>>>(
          (const u64*)table, n, (u64*)buf, levels, shift, n_split);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int smem = n_split * W * (int)sizeof(u64);
  if (W == 1) {
    search_kernel<1><<<blocks, kThreads, smem, stream>>>(
        (const u64*)table, n, (const u64*)buf, levels, log_lines, n_split,
        (const u64*)queries, m, (long long*)out);
  } else {
    search_kernel<2><<<blocks, kThreads, smem, stream>>>(
        (const u64*)table, n, (const u64*)buf, levels, log_lines, n_split,
        (const u64*)queries, m, (long long*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
