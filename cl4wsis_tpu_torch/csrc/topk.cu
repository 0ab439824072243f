// Exact top-k along the rows of a float32 matrix, descending; among equal
// values the lower column index wins (the order of jax.lax.top_k, with
// +0.0 above -0.0 and -inf allowed).
//
// Replaces cl4wsis_tpu/ops/pallas_topk.py::topk_pallas, which keeps a whole
// row in VMEM and extracts the maximum k times. A Hopper SM has at most
// 227 KB of shared memory, far less than a 1 MiB row, so the row is cut into
// chunks instead. Any global top-k has at most k members in each chunk, so
// the union of the chunks' top-k holds the answer (the argument of
// cl4wsis_tpu/ops/topk.py); levels repeat until one chunk is left.
//
// Each element becomes one 64-bit key: the value's bits mapped to an
// unsigned order in the high word and (0xFFFFFFFF - column) in the low word.
// A larger key is a larger value or, for equal values, a lower column, so
// one unsigned compare gives the exact order and ties need no extra pass.
// Padding keys are 0, below every real key.
//
// Bound on the H100: bytes. The serving call reads a (20, 262144) float32
// plane once (21 MB, about 6.3 us at 3.35 TB/s) and writes 20 x 32 results.
// This design reads each value once in the first level and sorts 4096 keys
// per block in shared memory (a bitonic network, 78 barrier steps), so it is
// bound by the sort, not by the bytes; a later change can keep only a
// running top-k per block instead of sorting whole chunks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 4096;   // keys one block sorts: 32 KB of shared memory
constexpr int kThreads = 1024;

__device__ __forceinline__ uint32_t orderable(float v) {
  uint32_t b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ unsigned long long make_key(float v, uint32_t col) {
  return ((unsigned long long)orderable(v) << 32) |
         (unsigned long long)(0xFFFFFFFFu - col);
}

__device__ __forceinline__ uint32_t key_col(unsigned long long key) {
  return 0xFFFFFFFFu - (uint32_t)(key & 0xFFFFFFFFull);
}

// One block sorts one chunk of one row in descending order and keeps its
// first k keys. The first level makes the keys from `x` (kin == nullptr); a
// later level reads the previous level's candidates from `kin`, whose rows
// are `len` keys long. With `vals` set this is the last level (a single
// chunk per row): the block writes values, read back from `x`, and columns.
__global__ void __launch_bounds__(kThreads)
topk_chunk_kernel(const float* __restrict__ x, int n, const unsigned long long* __restrict__ kin,
                  int len, int k, unsigned long long* __restrict__ kout,
                  float* __restrict__ vals, int* __restrict__ cols) {
  __shared__ unsigned long long s[kChunk];
  const int row = blockIdx.y;
  const int chunk = blockIdx.x;
  const long long base = (long long)chunk * kChunk;
  for (int i = threadIdx.x; i < kChunk; i += blockDim.x) {
    const long long j = base + i;
    unsigned long long key = 0ull;
    if (j < len) {
      key = kin ? kin[(long long)row * len + j]
                : make_key(x[(long long)row * n + j], (uint32_t)j);
    }
    s[i] = key;
  }
  __syncthreads();

  for (int size = 2; size <= kChunk; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < kChunk; i += blockDim.x) {
        const int j = i ^ stride;
        if (j > i) {
          const unsigned long long a = s[i], b = s[j];
          const bool descending = (i & size) == 0;
          if (descending ? (a < b) : (a > b)) {
            s[i] = b;
            s[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const unsigned long long key = s[i];
    if (vals) {
      const uint32_t c = key_col(key);
      cols[(long long)row * k + i] = (int)c;
      vals[(long long)row * k + i] = x[(long long)row * n + c];
    } else {
      kout[((long long)row * gridDim.x + chunk) * k + i] = key;
    }
  }
}

}  // namespace

extern "C" int cl4_topk_chunk() { return kChunk; }

// x: (B, N) float32 rows. vals/cols: (B, k). scratch0/scratch1: each at least
// B * ceil(N / kChunk) * k keys (unused when N <= kChunk). Needs
// 1 <= k <= min(N, kChunk / 2), so that every level shrinks its rows.
extern "C" int cl4_topk_f32(const float* x, int B, int N, int k, float* vals,
                            int* cols, unsigned long long* scratch0,
                            unsigned long long* scratch1, void* stream) {
  if (B < 1 || N < 1 || k < 1 || k > N || k > kChunk / 2 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* bufs[2] = {scratch0, scratch1};
  const unsigned long long* kin = nullptr;
  int len = N;
  for (int level = 0;; ++level) {
    const int chunks = (len + kChunk - 1) / kChunk;
    const dim3 grid(chunks, B);
    if (chunks == 1) {
      topk_chunk_kernel<<<grid, kThreads, 0, st>>>(x, N, kin, len, k, nullptr, vals, cols);
      break;
    }
    unsigned long long* out = bufs[level & 1];
    topk_chunk_kernel<<<grid, kThreads, 0, st>>>(x, N, kin, len, k, out, nullptr, nullptr);
    kin = out;
    len = chunks * k;
  }
  return (int)cudaGetLastError();
}
