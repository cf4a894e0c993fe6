// Stable LSD radix sort of (key limbs, int32 key, uint8 payload) rows on
// Hopper, in the onesweep style: one histogram launch, then one scatter
// launch per 8-bit digit that varies.
//
// Replaces ska_tpu/ops/sort.py::_window_kernel_body / _window_call, the
// TPU Pallas kernel that runs the bitonic compare-exchange stages below a
// VMEM window. The port's merged build (ska_tpu_torch/ops/pipeline.py)
// runs it as the one global sort by (split k-mer key, sample id) that
// carries the IUPAC set. Order: the int64 limbs compared as unsigned
// 64-bit words, first limb most significant, then the int32 key compared
// signed (its sign bit flipped gives unsigned order); the payload rides
// along. Equal rows keep their input order. The reads build's sorts are
// by the limbs alone: the wrapper launches no pass for the int32's
// digits, so it rides along as payload too (the row's position, which
// gathers wider payloads afterwards). The histogram still counts its
// digits.
//
// What bounds it: device-memory bandwidth. Each scatter pass reads and
// writes every row once, 8W+5 bytes each way, and the histogram reads the
// key operands once, so a sort moves about (passes + 1) x bytes per row x
// N, with passes = the digits that vary. Why radix and not a network: a
// bitonic network over 2^25 rows has 325 compare-exchange stages, and
// even with the strides below a shared-memory tile kept on chip, 105 of
// them plus 15 tile launches go through device memory, 120 launches in
// all; radix sorts the main path's rows in 9 scatter passes at W=1 (8
// key digits and the low digit of a sample id below 256) and 17 at W=2.
//
// Design:
// - histogram_kernel reads the key operands once and counts all 4+8W
//   digits at once into shared-memory bins (for the sample id's digits,
//   one atomic per warp where all its lanes share one), adds them to a
//   global histogram, and the last block to finish writes each digit's
//   exclusive scan and whether the digit is trivial (one non-empty bin).
//   The wrapper reads those flags and launches no pass for such a digit.
// - scatter_kernel, one launch per pass: each block takes its tile index
//   from an atomic counter (so every earlier tile belongs to a block that
//   has started, and the look-back cannot wait on a block that cannot
//   run), loads every operand of a tile of kTile rows coalesced in one
//   round of loads (warp w owns rows [w*32*I, (w+1)*32*I) of the tile,
//   I = kItems, lane l of round k row k*32+l), ranks them stably by digit
//   (__match_any_sync peers within a round, running per-warp counts
//   across rounds, then prefixes across warps), publishes its per-digit
//   counts with flag bits, gets its global prefix by decoupled look-back
//   over earlier tiles, reorders the tile by digit in shared memory and
//   writes contiguous runs of every operand. The digit comes from the
//   loaded operand, so every byte is read from device memory once.
//
// Plain C interface for ctypes: every function launches on the given
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (0 when the launch was accepted). The wrapper,
// ska_tpu_torch/ops/sort.py, allocates the scratch and the ping-pong
// buffers, and makes the digit plan (which operand and shift each digit
// index reads).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads per block, one per bin
constexpr int kBins = 256;     // 8-bit digits
constexpr int kWarps = kThreads / 32;
// rows per thread of a scatter tile, every operand of them held in
// registers at 2 blocks per SM (128 registers, no spills). On the H100,
// 3 or 4 blocks per SM with fewer rows each were slower.
template <int W>
constexpr int kItems = W == 1 ? 15 : 11;
template <int W>
constexpr int kTile = kThreads * kItems<W>;  // 3840 rows at W=1, 2816 at W=2
constexpr int kHistRows = 4;   // rows per thread per histogram step
constexpr unsigned kFull = 0xffffffffu;
// tile status word: flag in the top two bits, count in the low 30
constexpr unsigned kFlagAggregate = 1u << 30;
constexpr unsigned kFlagPrefix = 2u << 30;
constexpr unsigned kValue = (1u << 30) - 1;

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

// the int32 key with its sign bit flipped: unsigned order = signed order
__device__ __forceinline__ unsigned sid_bits(int x) {
  return (unsigned)x ^ 0x80000000u;
}

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// Exclusive scan of one value per thread over the block, in thread
// order. Every thread must call it; it synchronises the block.
__device__ __forceinline__ unsigned block_exclusive_scan(unsigned v,
                                                         unsigned* s_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    unsigned y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_sums[warp] = x;
  __syncthreads();
  unsigned before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) before += w < warp ? s_sums[w] : 0;
  __syncthreads();  // s_sums may be reused
  return before + x - v;
}

// Count one digit per lane into shared bins, for digits that come in
// runs (the sample id's: rows of one sample are contiguous). All lanes of
// the warp call it; `valid` lanes count. Where every valid lane holds the
// same digit, one atomic adds them all.
__device__ __forceinline__ void count_run_digit(unsigned* bins, unsigned dig,
                                                bool valid) {
  const unsigned mask = __ballot_sync(kFull, valid);
  if (!mask) return;
  const int leader = __ffs(mask) - 1;
  const unsigned first = __shfl_sync(kFull, dig, leader);
  if (__all_sync(kFull, !valid || dig == first)) {
    if ((int)(threadIdx.x & 31) == leader) atomicAdd(&bins[first], __popc(mask));
  } else if (valid) {
    atomicAdd(&bins[dig], 1u);
  }
}

// scratch: hist[D][256] (zeroed by the caller), offsets[D][256],
// trivial[D], done (zeroed). Digit d in LSD order: d < 4 byte d of the
// int32 key, then the 8 bytes of each limb, last limb first.
template <int W>
__global__ void __launch_bounds__(kThreads)
histogram_kernel(Rows<W> in, long long n, unsigned* scratch) {
  constexpr int D = 4 + 8 * W;
  __shared__ unsigned sh[D * kBins];
  __shared__ unsigned s_sums[kWarps];
  __shared__ bool s_last;
  unsigned* hist = scratch;
  unsigned* offsets = scratch + D * kBins;
  unsigned* trivial = scratch + 2 * D * kBins;
  unsigned* done = trivial + D;
  const int t = threadIdx.x;
  for (int i = t; i < D * kBins; i += kThreads) sh[i] = 0;
  __syncthreads();

  const long long step = (long long)gridDim.x * kThreads * kHistRows;
  for (long long base = (long long)blockIdx.x * kThreads * kHistRows;
       base < n; base += step) {
    unsigned long long limb[kHistRows][W];
    unsigned key[kHistRows];
    bool valid[kHistRows];
#pragma unroll
    for (int j = 0; j < kHistRows; ++j) {
      const long long row = base + j * kThreads + t;
      valid[j] = row < n;
      key[j] = valid[j] ? sid_bits(in.sid[row]) : 0u;
#pragma unroll
      for (int w = 0; w < W; ++w) limb[j][w] = valid[j] ? in.key[w][row] : 0ull;
    }
#pragma unroll
    for (int j = 0; j < kHistRows; ++j) {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        count_run_digit(sh + b * kBins, (key[j] >> (8 * b)) & 0xff,
                        valid[j]);
#pragma unroll
      for (int l = 0; l < W; ++l) {
        const unsigned long long x = limb[j][W - 1 - l];
        if (valid[j]) {
#pragma unroll
          for (int b = 0; b < 8; ++b)
            atomicAdd(sh + (4 + 8 * l + b) * kBins + ((x >> (8 * b)) & 0xff),
                      1u);
        }
      }
    }
  }
  __syncthreads();
  for (int i = t; i < D * kBins; i += kThreads)
    if (sh[i]) atomicAdd(hist + i, sh[i]);
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last block: per-digit exclusive scan over the bins, bin t here
  for (int d = 0; d < D; ++d) {
    const unsigned c = __ldcg(hist + d * kBins + t);
    offsets[d * kBins + t] = block_exclusive_scan(c, s_sums);
    const int nonzero = __syncthreads_count(c != 0);
    if (t == 0) trivial[d] = nonzero <= 1;
  }
}

// Move one operand of the tile, held in registers: the value of row
// (warp, round k, lane) goes to shared slot code[k] >> 9, then slot q to
// dst[gdst[digit of q] + q], so each warp writes contiguous runs.
template <int ITEMS, typename T>
__device__ __forceinline__ void move_operand(
    const T (&v)[ITEMS], T* __restrict__ dst, const unsigned (&code)[ITEMS],
    void* s_buf, const unsigned char* s_dig, const int* s_gdst, int n_tile) {
  T* sb = (T*)s_buf;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k)
    if ((code[k] & 0x1ff) < kBins) sb[code[k] >> 9] = v[k];
  __syncthreads();
  for (int q = threadIdx.x; q < n_tile; q += kThreads)
    dst[(long long)s_gdst[s_dig[q]] + q] = sb[q];
  __syncthreads();
}

// One stable pass over the digit (operand, shift): operand < W reads limb
// `operand`, operand == W the int32 key. offsets: the digit's 256
// exclusive bin starts. status: [tile counter][tiles][256], zeroed.
template <int W>
__global__ void __launch_bounds__(kThreads, 2)
scatter_kernel(Rows<W> in, Rows<W> out, long long n, int operand, int shift,
               const unsigned* __restrict__ offsets, unsigned* status) {
  __shared__ unsigned s_warp[kWarps][kBins];  // counts, then warp prefixes
  __shared__ unsigned s_start[kBins];         // tile-local digit starts
  __shared__ int s_gdst[kBins];               // slot q -> s_gdst[d] + q
  __shared__ unsigned s_sums[kWarps];
  __shared__ unsigned s_tile;
  constexpr int kI = kItems<W>;
  constexpr int kT = kTile<W>;
  __shared__ unsigned char s_dig[kT];
  __shared__ unsigned long long s_buf[kT];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s_warp[w][t] = 0;
  if (t == 0) s_tile = atomicAdd(status, 1u);
  __syncthreads();
  const unsigned tile = s_tile;
  const long long tile_base = (long long)tile * kT;
  const long long warp_base = tile_base + (long long)warp * 32 * kI;
  const int n_tile = (int)min((long long)kT, n - tile_base);

  // 1. every operand of the warp's rows in one round of loads; the digit
  //    comes from the loaded value. code[k] = digit | rank << 9, digit
  //    kBins where there is no row.
  unsigned long long key[W][kI];
  int sid[kI];
  unsigned char set[kI];
  unsigned code[kI];
#pragma unroll
  for (int k = 0; k < kI; ++k) {
    const long long row = warp_base + k * 32 + lane;
    if (row < n) {
#pragma unroll
      for (int w = 0; w < W; ++w) key[w][k] = in.key[w][row];
      sid[k] = in.sid[row];
      set[k] = in.set[row];
    }
  }
#pragma unroll
  for (int k = 0; k < kI; ++k) {
    unsigned d = kBins;
    if (warp_base + k * 32 + lane < n) {
      unsigned long long x = key[0][k];
      if (W == 2 && operand == 1) x = key[W - 1][k];
      d = (operand == W ? sid_bits(sid[k]) >> shift
                        : (unsigned)(x >> shift)) & 0xff;
    }
    code[k] = d;
  }
  // ranks within the warp: peers of a round by match, earlier rounds by
  // the warp's running counts
  const unsigned lanes_below = (1u << lane) - 1;
#pragma unroll
  for (int k = 0; k < kI; ++k) {
    const unsigned d = code[k];
    const unsigned peers = __match_any_sync(kFull, d);
    const unsigned below = __popc(peers & lanes_below);
    const unsigned prev = d < kBins ? s_warp[warp][d] : 0;
    __syncwarp();
    if (d < kBins && below == 0) s_warp[warp][d] = prev + __popc(peers);
    __syncwarp();
    code[k] = d | ((prev + below) << 9);
  }
  __syncthreads();

  // 2. thread t owns digit t: prefixes across warps, the tile's count
  unsigned count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned c = s_warp[w][t];
    s_warp[w][t] = count;
    count += c;
  }
  const unsigned start = block_exclusive_scan(count, s_sums);

  // 3. decoupled look-back: publish the count, add earlier tiles' counts
  //    until one has published its inclusive prefix. The status word
  //    carries flag and count together and nothing else passes between
  //    tiles, so relaxed stores and loads need no fence.
  unsigned* tiles = status + 1;
  unsigned* mine = tiles + (long long)tile * kBins + t;
  unsigned excl = 0;
  if (tile > 0) {
    st_relaxed(mine, kFlagAggregate | count);
    for (long long j = (long long)tile - 1;; ) {
      const unsigned s = ld_relaxed(tiles + j * kBins + t);
      if (!(s & ~kValue)) continue;  // not published yet
      excl += s & kValue;
      if (s & kFlagPrefix) break;
      --j;
    }
  }
  st_relaxed(mine, kFlagPrefix | (excl + count));
  s_start[t] = start;
  s_gdst[t] = (int)(offsets[t] + excl) - (int)start;
  __syncthreads();

  // 4. tile-local slot of every row: digit start + warp prefix + rank
#pragma unroll
  for (int k = 0; k < kI; ++k) {
    const unsigned d = code[k] & 0x1ff;
    if (d < kBins) {
      const unsigned slot = (code[k] >> 9) + s_start[d] + s_warp[warp][d];
      code[k] = d | (slot << 9);
      s_dig[slot] = (unsigned char)d;
    }
  }

  // 5. every operand through shared memory, written as contiguous runs
#pragma unroll
  for (int w = 0; w < W; ++w)
    move_operand(key[w], out.key[w], code, s_buf, s_dig, s_gdst, n_tile);
  move_operand(sid, out.sid, code, s_buf, s_dig, s_gdst, n_tile);
  move_operand(set, out.set, code, s_buf, s_dig, s_gdst, n_tile);
}

}  // namespace

extern "C" {

// Histogram, per-digit scans and trivial-digit flags of n rows (see
// histogram_kernel for the scratch layout).
int ska_radix_histogram(int W, const void* k0, const void* k1,
                        const void* sid, long long n, void* scratch,
                        int blocks, cudaStream_t stream) {
  if (W == 1) {
    histogram_kernel<1><<<blocks, kThreads, 0, stream>>>(
        make_rows<1>(k0, k1, sid, nullptr), n, (unsigned*)scratch);
  } else {
    histogram_kernel<2><<<blocks, kThreads, 0, stream>>>(
        make_rows<2>(k0, k1, sid, nullptr), n, (unsigned*)scratch);
  }
  return (int)cudaGetLastError();
}

// One scatter pass from the rows (k0, k1, sid, set) into (o0, o1, osid,
// oset) by the digit (operand, shift); tiles = ceil(n / ska_radix_tile()).
int ska_radix_scatter(int W, const void* k0, const void* k1, const void* sid,
                      const void* set, void* o0, void* o1, void* osid,
                      void* oset, long long n, int operand, int shift,
                      const void* offsets, void* status, long long tiles,
                      cudaStream_t stream) {
  if (W == 1) {
    scatter_kernel<1><<<(unsigned)tiles, kThreads, 0, stream>>>(
        make_rows<1>(k0, k1, sid, set), make_rows<1>(o0, o1, osid, oset), n,
        operand, shift, (const unsigned*)offsets, (unsigned*)status);
  } else {
    scatter_kernel<2><<<(unsigned)tiles, kThreads, 0, stream>>>(
        make_rows<2>(k0, k1, sid, set), make_rows<2>(o0, o1, osid, oset), n,
        operand, shift, (const unsigned*)offsets, (unsigned*)status);
  }
  return (int)cudaGetLastError();
}

// rows per scatter tile at W; the wrapper checks them against its own
int ska_radix_tile(int W) { return W == 1 ? kTile<1> : kTile<2>; }

}  // extern "C"
