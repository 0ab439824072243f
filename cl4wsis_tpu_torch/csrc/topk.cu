// Exact top-k along the rows of a float32 matrix, descending; among equal
// values the lower column index wins (the order of jax.lax.top_k, with
// +0.0 above -0.0 and -inf allowed; NaN is not accepted).
//
// Replaces cl4wsis_tpu/ops/pallas_topk.py::topk_pallas, which keeps a whole
// row in VMEM and extracts the maximum k times. A Hopper SM has at most
// 227 KB of shared memory, far less than a 1 MiB row, so the row is cut into
// segments of kSeg values instead. Any global top-k has at most k members in
// each segment, so the union of the segments' top-k holds the answer (the
// argument of cl4wsis_tpu/ops/topk.py); levels repeat until one segment is
// left.
//
// Each element becomes one 64-bit key: the value's bits mapped to an
// unsigned order in the high word and (0xFFFFFFFF - column) in the low word.
// A larger key is a larger value or, for equal values, a lower column, so
// one unsigned compare gives the exact order and ties need no extra pass.
// Keys are unique. A real key is never 0 (its low word is at least 2^31),
// so 0 marks padding.
//
// Select, don't sort. One block of 256 threads holds one segment of 4096
// keys in registers, 16 consecutive ones a thread, so that position order
// is column order. It finds the segment's k-th largest high word by a
// search over its bits that jumps: it keeps the range [lo, hi] of high
// words that holds the answer, both ends real values, and tests the
// candidate hi with the bits below the highest bit where lo and hi differ
// cleared. One block-wide reduction (warp reductions and a shared sum of
// the warp totals, no histogram, no atomic) gives, for the candidate, the
// count of keys at or above it, the least of those and the greatest of the
// rest; the range shrinks to one side and the next candidate skips every
// bit its two ends share. The search stops when a candidate keeps exactly k
// keys or the range is one value, so a segment that is mostly one value
// (the step's 0.0 and -1.0 rows) takes one round, a random one about 15.
// Once at most 512 keys lie in the range, they are compacted into shared
// memory and one warp takes the remaining rounds with warp reductions
// alone, leaving the SM's issue slots to other blocks. Among the keys
// whose high word equals the k-th, the lowest columns win: one block-wide
// prefix sum over position order ranks them, and the same sum places the
// kept keys, compacted, in column order. The last level (one segment per
// row) ranks its k survivors against each other in shared memory and
// writes values, read back from `x`, and columns in descending key order.
//
// Bound on the H100: bytes. The phase-2 step's (80, 262144) rows are 84 MB,
// read once: 25 us at 3.35 TB/s. The first level issues each thread's four
// 16-byte loads before any compute and keeps only the high words (the
// column follows from the position); its work per key is 6 integer
// operations per block-wide round, and the second level reads 64 k keys
// per row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;                // consecutive keys a thread holds
constexpr int kSeg = kThreads * kPer;   // keys one block selects from
constexpr int kMaxK = 1024;
constexpr int kPool = 32 * kPer;        // keys the last rounds take in a warp

__device__ __forceinline__ uint32_t orderable(float v) {
  uint32_t b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Block-wide sum, minimum and minimum of three values per thread. Two
// buffers of warp results are used in turn: a warp writes a buffer again
// only after the next barrier, which every warp reaches after it has read
// that buffer.
struct BlockReduce {
  uint32_t* buf;   // shared, 2 * 3 * 32
  int turn;
  __device__ uint32_t* next() { return buf + (turn++ & 1) * 3 * 32; }
  __device__ void operator()(int& sum, uint32_t& min1, uint32_t& min2) {
    uint32_t* b = next();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const uint32_t s = __reduce_add_sync(0xffffffffu, (uint32_t)sum);
    const uint32_t m1 = __reduce_min_sync(0xffffffffu, min1);
    const uint32_t m2 = __reduce_min_sync(0xffffffffu, min2);
    if (lane == 0) {
      b[warp] = s;
      b[32 + warp] = m1;
      b[64 + warp] = m2;
    }
    __syncthreads();
    const bool in = lane < kWarps;
    sum = (int)__reduce_add_sync(0xffffffffu, in ? b[lane] : 0u);
    min1 = __reduce_min_sync(0xffffffffu, in ? b[32 + lane] : 0xFFFFFFFFu);
    min2 = __reduce_min_sync(0xffffffffu, in ? b[64 + lane] : 0xFFFFFFFFu);
  }
};

// Exclusive prefix sum over the block of one int per thread, in thread
// order, and the total: (prefix, total). `wt` is a buffer of BlockReduce's.
__device__ __forceinline__ int2 block_scan(int v, uint32_t* wt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) wt[warp] = (uint32_t)inc;
  __syncthreads();
  const int w = lane < kWarps ? (int)wt[lane] : 0;
  int winc = w;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, winc, d);
    if (lane >= d) winc += y;
  }
  return make_int2(__shfl_sync(0xffffffffu, winc - w, warp) + inc - v,
                   __shfl_sync(0xffffffffu, winc, 31));
}

// The next candidate of the search over [lo_a, hi_a] (lo_a < hi_a): hi_a
// with the bits below the highest bit where the two differ cleared.
__device__ __forceinline__ uint32_t candidate(uint32_t lo_a, uint32_t hi_a) {
  const int d = 31 - __clz(lo_a ^ hi_a);
  return (hi_a >> d) << d;
}

// A thread's part of one round: its keys at or above cand, the least of
// them minus cand, and cand - 1 minus the greatest below cand. Unsigned
// wrap-around puts padding (0) and the keys on the other side of cand above
// every real value of each, so plain minima suffice.
__device__ __forceinline__ void partials(const uint32_t (&h)[kPer],
                                         uint32_t cand, int& c, uint32_t& up,
                                         uint32_t& down) {
  c = 0;
  up = down = 0xFFFFFFFFu;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    c += h[j] >= cand;
    up = min(up, h[j] - cand);
    down = min(down, cand - 1u - h[j]);
  }
}

// Narrow [lo_a, hi_a] to the side of cand that holds the k-th largest high
// word, given the round's totals. True when the answer is found: a range
// of one value, or exactly k keys at or above cand (then lo_a = cand - 1,
// so that the keys above lo_a are those k).
__device__ __forceinline__ bool narrow(int c, uint32_t up, uint32_t down,
                                       uint32_t cand, int k, uint32_t& lo_a,
                                       uint32_t& hi_a, int& n_lo, int& n_hi) {
  if (c == k) {
    lo_a = hi_a = cand - 1u;
    return true;
  }
  if (c > k) {
    lo_a = cand + up;
    n_lo = c;
  } else {
    hi_a = cand - 1u - down;
    n_hi = c;
  }
  return lo_a == hi_a;
}

// One block selects the k largest keys of one segment of one row. The first
// level (kFromX) makes the keys from `x`, with the column implied by the
// position; a later level reads the previous level's keys from `kin`, whose
// rows are `len` keys long, in column order (0 marks padding). Not the last
// level: the block writes k keys to its slot of `kout` in column order, 0
// where the segment has fewer. The last level (vals set, one segment per
// row) writes values and columns in descending order.
template <bool kFromX>
__global__ void __launch_bounds__(kThreads)
topk_select_kernel(const float* __restrict__ x, int n,
                   const unsigned long long* __restrict__ kin, int len, int k,
                   unsigned long long* __restrict__ kout,
                   float* __restrict__ vals, int* __restrict__ cols) {
  __shared__ uint32_t red[2 * 3 * 32];
  __shared__ uint32_t pool[kPool];
  __shared__ unsigned long long kept[kMaxK];
  const int t = threadIdx.x;
  const int row = blockIdx.y;
  const long long first = (long long)blockIdx.x * kSeg + (long long)t * kPer;
  uint32_t hi[kPer];                  // hi == 0: no key (padding)
  uint32_t lo[kFromX ? 1 : kPer];

  if constexpr (kFromX) {
    const float* xr = x + (long long)row * n;
    if (first + kPer <= n && ((uintptr_t)(xr + first) & 15) == 0) {
      const float4* x4 = reinterpret_cast<const float4*>(xr + first);
      float4 q[kPer / 4];
#pragma unroll
      for (int i = 0; i < kPer / 4; ++i) q[i] = __ldg(x4 + i);
#pragma unroll
      for (int i = 0; i < kPer / 4; ++i) {
        hi[4 * i] = orderable(q[i].x);
        hi[4 * i + 1] = orderable(q[i].y);
        hi[4 * i + 2] = orderable(q[i].z);
        hi[4 * i + 3] = orderable(q[i].w);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        hi[j] = first + j < n ? orderable(__ldg(xr + first + j)) : 0u;
    }
  } else {
    const unsigned long long* kr = kin + (long long)row * len;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const unsigned long long key = first + j < len ? kr[first + j] : 0ull;
      hi[j] = (uint32_t)(key >> 32);
      lo[j] = (uint32_t)key;
    }
  }
  auto key_of = [&](int j) -> unsigned long long {
    uint32_t low;
    if constexpr (kFromX) {
      low = 0xFFFFFFFFu - (uint32_t)(first + j);
    } else {
      low = lo[j];
    }
    return ((unsigned long long)hi[j] << 32) | low;
  };

  // Count the keys and find the range of their high words.
  BlockReduce reduce{red, 0};
  int m = 0;
  uint32_t lo_a = 0xFFFFFFFFu, neg_hi_a = 0xFFFFFFFFu;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    m += hi[j] != 0u;
    lo_a = min(lo_a, hi[j] - 1u);          // padding wraps to the top
    neg_hi_a = min(neg_hi_a, ~hi[j]);
  }
  reduce(m, lo_a, neg_hi_a);
  lo_a += 1u;
  uint32_t hi_a = ~neg_hi_a;

  // th: keys with a high word above th are kept, and of those equal to th
  // the first (k - kept above) in column order. With k or fewer keys, keep
  // them all (th 0 keeps every real key, and no padding).
  uint32_t th = 0u;
  if (m > k) {
    // The k-th largest high word lies in [lo_a, hi_a], both real values;
    // n_lo keys lie at or above lo_a and n_hi above hi_a. Block-wide rounds
    // while more than kPool keys lie in the range.
    int n_lo = m, n_hi = 0;
    bool done = lo_a == hi_a;
    while (!done && n_lo - n_hi > kPool) {
      const uint32_t cand = candidate(lo_a, hi_a);
      int c;
      uint32_t up, down;
      partials(hi, cand, c, up, down);
      reduce(c, up, down);
      done = narrow(c, up, down, cand, k, lo_a, hi_a, n_lo, n_hi);
    }
    if (!done) {
      // The rest in one warp: the keys in the range, compacted into shared
      // memory in any order (kPer a lane, 0 padding), and warp reductions.
      int in_range = 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        in_range += hi[j] >= lo_a && hi[j] <= hi_a;
      int at = block_scan(in_range, reduce.next()).x;
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if (hi[j] >= lo_a && hi[j] <= hi_a) pool[at++] = hi[j];
      for (int i = n_lo - n_hi + t; i < kPool; i += kThreads) pool[i] = 0u;
      __syncthreads();
      if (t < 32) {
        const int above_pool = n_hi;   // keys above the pool's range
        uint32_t h[kPer];
#pragma unroll
        for (int j = 0; j < kPer; ++j) h[j] = pool[t * kPer + j];
        while (!done) {
          const uint32_t cand = candidate(lo_a, hi_a);
          int c;
          uint32_t up, down;
          partials(h, cand, c, up, down);
          c = above_pool + (int)__reduce_add_sync(0xffffffffu, (uint32_t)c);
          up = __reduce_min_sync(0xffffffffu, up);
          down = __reduce_min_sync(0xffffffffu, down);
          done = narrow(c, up, down, cand, k, lo_a, hi_a, n_lo, n_hi);
        }
        if (t == 0) pool[0] = lo_a;
      }
      __syncthreads();
      lo_a = pool[0];
    }
    th = lo_a;
  }

  // One block-wide exclusive prefix sum over position order of the counts
  // above th (low half) and equal to th (high half): totals <= kSeg.
  int above = 0, equal = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    above += hi[j] > th;
    equal += hi[j] == th;
  }
  const int2 scan = block_scan(above | (equal << 16), reduce.next());
  const int before = scan.x, total = scan.y;
  // m <= k: th is 0, every real key is above it and no key equals it
  const int ties = m > k ? k - (total & 0xFFFF) : 0;
  int a = before & 0xFFFF, e = before >> 16;
  const int n_kept = (total & 0xFFFF) + ties;

  unsigned long long* out =
      vals ? kept : kout + ((long long)row * gridDim.x + blockIdx.x) * k;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const bool keep = hi[j] > th || (hi[j] == th && e < ties);
    if (keep) out[a + min(e, ties)] = key_of(j);
    a += hi[j] > th;
    e += hi[j] == th;
  }
  if (vals == nullptr) {
    for (int i = n_kept + t; i < k; i += kThreads) out[i] = 0ull;
    return;
  }

  // last level: the row has at least k real keys, so exactly k are kept
  __syncthreads();
  for (int i = t; i < k; i += kThreads) {
    const unsigned long long key = kept[i];
    int rank = 0;
    for (int j = 0; j < k; ++j) rank += kept[j] > key;
    const uint32_t col = 0xFFFFFFFFu - (uint32_t)key;
    cols[(long long)row * k + rank] = (int)col;
    vals[(long long)row * k + rank] = x[(long long)row * n + col];
  }
}

}  // namespace

extern "C" int cl4_topk_segment() { return kSeg; }
extern "C" int cl4_topk_max_k() { return kMaxK; }

// x: (B, N) float32 rows. vals/cols: (B, k). scratch0/scratch1: each at least
// B * ceil(N / kSeg) * k keys (unused when N <= kSeg). Needs
// 1 <= k <= min(N, kMaxK), so that every level shrinks its rows.
extern "C" int cl4_topk_f32(const float* x, int B, int N, int k, float* vals,
                            int* cols, unsigned long long* scratch0,
                            unsigned long long* scratch1, void* stream) {
  if (B < 1 || N < 1 || k < 1 || k > N || k > kMaxK || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* bufs[2] = {scratch0, scratch1};
  const unsigned long long* kin = nullptr;
  int len = N;
  for (int level = 0;; ++level) {
    const int segs = (len + kSeg - 1) / kSeg;
    const dim3 grid(segs, B);
    const bool last = segs == 1;
    unsigned long long* out = last ? nullptr : bufs[level & 1];
    if (level == 0)
      topk_select_kernel<true><<<grid, kThreads, 0, st>>>(
          x, N, kin, len, k, out, last ? vals : nullptr, cols);
    else
      topk_select_kernel<false><<<grid, kThreads, 0, st>>>(
          x, N, kin, len, k, out, last ? vals : nullptr, cols);
    if (last) break;
    kin = out;
    len = segs * k;
  }
  return (int)cudaGetLastError();
}
