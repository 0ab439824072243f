// Run totals over sorted key rows: for each element of an ascending-sorted
// int32 key row, the length of its equal-key run and the run's sums of three
// int32 payloads, exact in int32.
//
// Replaces cl4wsis_tpu/ops/pallas_seg.py::run_totals_pallas, which keeps a
// whole row in VMEM and runs a forward segmented-sum doubling pass and a
// backward fill pass, log2(N) shifted copies each.
//
// Bound on the H100: bytes. A (16, 262144) call reads four int32 rows and
// writes four: 134 MB, 0.040 ms at 3.35 TB/s. The first design here scanned
// plain prefix sums into three scratch rows and had every element binary-
// search its key row twice for its run's bounds: about 17 row passes of
// traffic, most of it scattered reads that wait on latency. This design
// reads every input once, with 16-byte loads, and writes every output once:
//   1. Tile pass. A block owns one tile of one row, a thread kItems
//      neighbouring elements in registers. Run heads and tails come from
//      comparing neighbouring keys (one halo key on each side of the tile).
//      A forward segmented scan gives each element the sum of its run up to
//      itself, a backward one the sum after itself; their sum is the run's
//      total inside the tile (the count rides along as a fourth payload).
//      Both scans run on warp shuffles, with one shared exchange of the
//      warps' carries. An element whose run starts and ends inside the tile
//      is final and is written here. Each tile also leaves a descriptor: the
//      extent and the sums of its first run if that run began in an earlier
//      tile (open to the left), and of its last run if it goes on in the
//      next tile (open to the right).
//   2. Fix-up. A block per tile reads its descriptor and returns at once if
//      no run of it is open. Otherwise one warp chains the descriptors of
//      the tiles to the left, another those to the right (32 tiles a step,
//      through tiles that are a single open run, up to the tile where the run
//      begins or ends), and the block fills the open extent with the run's
//      full total: plain stores over a known extent, no key read.
// No block waits for another: the second launch starts when the first is
// done. Sums are taken in uint32, so they wrap as the plain version's int32
// does. Any N >= 1 and any number of rows are taken; rows whose length is not
// a multiple of 4 (or pointers off 16 bytes) take scalar loads and stores.
// The block shapes below are what a sweep on the card chose: more elements a
// thread split its 16-byte stores over half sectors, larger tiles left the
// one-row serving call with too few blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;  // elements a thread owns
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
// the fix-up waits on its descriptor reads: small blocks, so that many are
// resident and one's wait hides behind another's stores
constexpr int kFixThreads = 64;
constexpr int kDesc = 8;  // uint32 per tile: open-left count, 3 sums; open-right
constexpr unsigned kAll = 0xffffffffu;

static_assert(kThreads % 32 == 0 && kWarps <= 32, "block shape");
static_assert(kItems % 4 == 0 && kItems <= 32, "items per thread");
static_assert(kFixThreads % 32 == 0 && kFixThreads >= 64, "a warp a side");

// A span's aggregate is four uint32: the count and the three payload sums of
// the part of a run that reaches the span's far end. Bit 31 of the count
// word says that a run boundary lies in the span (the count is at most
// kTile, so the bit is free): adding a farther span's words onto a nearer
// one's then carries the flag along, and a scan moves four words, not five.
constexpr unsigned kFlag = 0x80000000u;

__device__ __forceinline__ bool bounded(const unsigned (&v)[4]) {
  return (v[0] & kFlag) != 0u;
}

// `far` enters from outside, `near` is the nearer span: on return `near`
// holds what reaches past both.
__device__ __forceinline__ void chain(const unsigned (&far)[4], unsigned (&near)[4]) {
  if (!bounded(near)) {
#pragma unroll
    for (int q = 0; q < 4; ++q) near[q] += far[q];
  }
}

// Inclusive segmented scan over the first WIDTH lanes of a warp (WIDTH a
// power of two). FWD scans from lane 0 up (boundaries are run heads), else
// from the top lane down (run tails).
template <bool FWD, int WIDTH>
__device__ __forceinline__ void warp_seg_scan(unsigned (&v)[4], int lane) {
#pragma unroll
  for (int d = 1; d < WIDTH; d <<= 1) {
    unsigned o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      o[q] = FWD ? __shfl_up_sync(kAll, v[q], d) : __shfl_down_sync(kAll, v[q], d);
    if (FWD ? lane >= d : lane + d < WIDTH) chain(o, v);
  }
}

// The inclusive scan of the lane before (FWD) or after this one: what enters
// the lane from the rest of its warp. The outermost lane gets nothing.
template <bool FWD>
__device__ __forceinline__ void shift_one(unsigned (&v)[4], int lane) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const unsigned o = FWD ? __shfl_up_sync(kAll, v[q], 1) : __shfl_down_sync(kAll, v[q], 1);
    v[q] = (FWD ? lane == 0 : lane == 31) ? 0u : o;
  }
}

constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }
constexpr int kCarryWidth = pow2_at_least(kWarps);  // lanes the warps' aggregates fill

// What enters warp `warp` from the warps before (FWD) or after it, from the
// warps' aggregates in shared memory. Every warp scans them for itself.
template <bool FWD>
__device__ __forceinline__ void warp_carry(const unsigned (*agg)[4], int warp, int lane,
                                           unsigned (&v)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = lane < kWarps ? agg[lane][q] : 0u;
  warp_seg_scan<FWD, kCarryWidth>(v, lane);
  const bool none = FWD ? warp == 0 : warp == kWarps - 1;
  const int from = none ? 0 : (FWD ? warp - 1 : warp + 1);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const unsigned o = __shfl_sync(kAll, v[q], from);
    v[q] = none ? 0u : o;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
rt_tile_pass(const int* __restrict__ key, const int* __restrict__ p1,
             const int* __restrict__ p2, const int* __restrict__ p3, int N,
             int n_tiles, int* __restrict__ o0, int* __restrict__ o1,
             int* __restrict__ o2, int* __restrict__ o3,
             unsigned* __restrict__ desc) {
  __shared__ int s_first[kThreads];
  __shared__ int s_last[kThreads];
  __shared__ unsigned s_agg[2][kWarps][4];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long row = blockIdx.x / n_tiles;
  const int tile = (int)(blockIdx.x - row * n_tiles);
  const long long base = row * N;
  const long long j0 = (long long)tile * kTile + (long long)t * kItems;

  // this thread's elements: key and (count, v1, v2, v3); padding past the
  // row's end counts nothing and is a run of its own
  int k[kItems];
  unsigned v[4][kItems];
  if (VEC && j0 + kItems <= N) {
#pragma unroll
    for (int g = 0; g < kItems / 4; ++g) {
      const long long at = base + j0 + 4 * g;
      const int4 a = *reinterpret_cast<const int4*>(key + at);
      const int4 b = *reinterpret_cast<const int4*>(p1 + at);
      const int4 c = *reinterpret_cast<const int4*>(p2 + at);
      const int4 d = *reinterpret_cast<const int4*>(p3 + at);
      k[4 * g] = a.x; k[4 * g + 1] = a.y; k[4 * g + 2] = a.z; k[4 * g + 3] = a.w;
      v[1][4 * g] = b.x; v[1][4 * g + 1] = b.y; v[1][4 * g + 2] = b.z; v[1][4 * g + 3] = b.w;
      v[2][4 * g] = c.x; v[2][4 * g + 1] = c.y; v[2][4 * g + 2] = c.z; v[2][4 * g + 3] = c.w;
      v[3][4 * g] = d.x; v[3][4 * g + 1] = d.y; v[3][4 * g + 2] = d.z; v[3][4 * g + 3] = d.w;
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) v[0][i] = 1u;
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const bool in = j0 + i < N;
      const long long at = base + j0 + i;
      k[i] = in ? key[at] : 0;
      v[0][i] = in ? 1u : 0u;
      v[1][i] = in ? (unsigned)p1[at] : 0u;
      v[2][i] = in ? (unsigned)p2[at] : 0u;
      v[3][i] = in ? (unsigned)p3[at] : 0u;
    }
  }
  // halo keys, asked for before the barrier so that they are in flight
  int halo = 0;
  if (t == 0 && tile > 0) halo = key[base + j0 - 1];
  if (t == kThreads - 1 && j0 + kItems < N) halo = key[base + j0 + kItems];
  s_first[t] = k[0];
  s_last[t] = k[kItems - 1];
  __syncthreads();
  // the keys next to the thread's span; the halo is only read where the row
  // goes on (elsewhere the element is the row's first or last)
  const int prev = t > 0 ? s_last[t - 1] : halo;
  const int next = t < kThreads - 1 ? s_first[t + 1] : halo;

  // heads and tails of runs, one bit an element
  unsigned heads = 0u, tails = 0u;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long j = j0 + i;
    const int left = i > 0 ? k[i - 1] : prev;
    const int right = i < kItems - 1 ? k[i + 1] : next;
    const bool h = j >= N || j == 0 || k[i] != left;
    const bool e = j >= N - 1 || k[i] != right;
    heads |= (unsigned)h << i;
    tails |= (unsigned)e << i;
  }

  // in the thread: tot = the run's sum up to and with the element, then
  // plus the run's sum after it
  unsigned tot[4][kItems];
  unsigned fa[4] = {0u, 0u, 0u, 0u}, ba[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const bool h = (heads >> i) & 1u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      fa[q] = (h ? 0u : fa[q]) + v[q][i];
      tot[q][i] = fa[q];
    }
  }
#pragma unroll
  for (int i = kItems - 1; i >= 0; --i) {
    const bool e = (tails >> i) & 1u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      ba[q] = e ? 0u : ba[q];
      tot[q][i] += ba[q];
      ba[q] += v[q][i];
    }
  }
  if (heads) fa[0] |= kFlag;
  if (tails) ba[0] |= kFlag;

  // across the warp, then across the warps
  unsigned fin[4], bin[4];  // what enters this thread from the left, the right
#pragma unroll
  for (int q = 0; q < 4; ++q) { fin[q] = fa[q]; bin[q] = ba[q]; }
  warp_seg_scan<true, 32>(fin, lane);
  warp_seg_scan<false, 32>(bin, lane);
  if (lane == 31) {
#pragma unroll
    for (int q = 0; q < 4; ++q) s_agg[0][warp][q] = fin[q];
  }
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) s_agg[1][warp][q] = bin[q];
  }
  shift_one<true>(fin, lane);
  shift_one<false>(bin, lane);
  __syncthreads();
  unsigned wf[4], wb[4];
  warp_carry<true>(s_agg[0], warp, lane, wf);
  warp_carry<false>(s_agg[1], warp, lane, wb);
  chain(wf, fin);
  chain(wb, bin);

  // elements before the thread's first head take the left carry, those after
  // its last tail the right one; with no boundary on that side of them in
  // the whole tile, their run is open there
  const int first_head = heads ? __ffs(heads) - 1 : kItems;
  const int last_tail = tails ? 31 - __clz(tails) : -1;
  const unsigned open_l = bounded(fin) ? 0u : 1u, open_r = bounded(bin) ? 0u : 1u;
  unsigned open = 0u;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (i < first_head) {
      tot[0][i] += fin[0] & ~kFlag;
#pragma unroll
      for (int q = 1; q < 4; ++q) tot[q][i] += fin[q];
      open |= open_l << i;
    }
    if (i > last_tail) {
      tot[0][i] += bin[0] & ~kFlag;
#pragma unroll
      for (int q = 1; q < 4; ++q) tot[q][i] += bin[q];
      open |= open_r << i;
    }
  }

  // the descriptor: the tile's first run if it is open to the left, its last
  // run if it is open to the right (count 0 where it is not)
  unsigned* d = desc + (long long)blockIdx.x * kDesc;
  if (t == 0) {
    chain(bin, ba);
    *reinterpret_cast<uint4*>(d) = (heads & 1u)
        ? make_uint4(0u, 0u, 0u, 0u)
        : make_uint4(ba[0] & ~kFlag, ba[1], ba[2], ba[3]);
  }
  if (t == kThreads - 1) {
    chain(fin, fa);
    *reinterpret_cast<uint4*>(d + 4) = ((tails >> (kItems - 1)) & 1u)
        ? make_uint4(0u, 0u, 0u, 0u)
        : make_uint4(fa[0] & ~kFlag, fa[1], fa[2], fa[3]);
  }

  // write the elements whose run is closed on both sides
  int* outs[4] = {o0, o1, o2, o3};
#pragma unroll
  for (int g = 0; g < kItems / 4; ++g) {
    const unsigned m = (open >> (4 * g)) & 15u;
    const long long at = base + j0 + 4 * g;
    if (VEC && m == 0u && j0 + 4 * g + 4 <= N) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<int4*>(outs[q] + at) =
            make_int4((int)tot[q][4 * g], (int)tot[q][4 * g + 1],
                      (int)tot[q][4 * g + 2], (int)tot[q][4 * g + 3]);
    } else if (m != 15u) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (!((m >> i) & 1u) && j0 + 4 * g + i < N) {
#pragma unroll
          for (int q = 0; q < 4; ++q) outs[q][at + i] = (int)tot[q][4 * g + i];
        }
      }
    }
  }
}

// Sum over the descriptors of the tiles next to `tile` on one side, as far
// as the run that is open on that side of `tile` reaches: through tiles
// that are one open run, up to and with the first that is not. LEFT takes
// the neighbours' open-right part, else their open-left part. One warp,
// 32 tiles a step.
template <bool LEFT>
__device__ __forceinline__ void chain_tiles(const unsigned* __restrict__ row_desc,
                                            int tile, int n_tiles, int lane,
                                            unsigned (&sum)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) sum[q] = 0u;
  for (int step = 0;; step += 32) {
    const int s = LEFT ? tile - 1 - step - lane : tile + 1 + step + lane;
    const bool in = LEFT ? s >= 0 : s < n_tiles;
    uint4 l = make_uint4(0u, 0u, 0u, 0u), r = l;
    if (in) {
      l = *reinterpret_cast<const uint4*>(row_desc + (long long)s * kDesc);
      r = *reinterpret_cast<const uint4*>(row_desc + (long long)s * kDesc + 4);
    }
    const bool whole = in && l.x == (unsigned)kTile && r.x > 0u;
    const unsigned stops = __ballot_sync(kAll, !whole);
    const int last = stops ? __ffs(stops) - 1 : 31;
    const uint4 part = LEFT ? r : l;
    const unsigned c[4] = {part.x, part.y, part.z, part.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      unsigned x = lane <= last ? c[q] : 0u;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(kAll, x, d);
      sum[q] += x;
    }
    if (stops) return;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kFixThreads)
rt_fix_up(const unsigned* __restrict__ desc, int N, int n_tiles,
          int* __restrict__ o0, int* __restrict__ o1, int* __restrict__ o2,
          int* __restrict__ o3) {
  __shared__ unsigned s_tot[2][4];
  const unsigned* d = desc + (long long)blockIdx.x * kDesc;
  const uint4 l = *reinterpret_cast<const uint4*>(d);
  const uint4 r = *reinterpret_cast<const uint4*>(d + 4);
  if (l.x == 0u && r.x == 0u) return;  // no open run: the tile pass wrote all
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long row = blockIdx.x / n_tiles;
  const int tile = (int)(blockIdx.x - row * n_tiles);
  const unsigned* row_desc = desc + row * n_tiles * kDesc;
  const bool whole = l.x == (unsigned)kTile && r.x > 0u;  // one run right through
  if (warp == 0) {
    unsigned s[4] = {0u, 0u, 0u, 0u};
    if (l.x > 0u) chain_tiles<true>(row_desc, tile, n_tiles, lane, s);
    if (lane == 0) {
      s_tot[0][0] = s[0] + l.x; s_tot[0][1] = s[1] + l.y;
      s_tot[0][2] = s[2] + l.z; s_tot[0][3] = s[3] + l.w;
    }
  } else if (warp == 1) {
    unsigned s[4] = {0u, 0u, 0u, 0u};
    if (r.x > 0u) chain_tiles<false>(row_desc, tile, n_tiles, lane, s);
    if (lane == 0) {
      s_tot[1][0] = s[0] + r.x; s_tot[1][1] = s[1] + r.y;
      s_tot[1][2] = s[2] + r.z; s_tot[1][3] = s[3] + r.w;
    }
  }
  __syncthreads();
  unsigned a[4], b[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) { a[q] = s_tot[0][q]; b[q] = s_tot[1][q]; }
  if (whole) {  // both sides hold the tile's own sum
    const unsigned own[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) a[q] = b[q] = a[q] + b[q] - own[q];
  }
  // elements [0, n_left) take a, elements [from_right, kTile) take b
  const int n_left = (int)l.x;
  const int from_right = kTile - (int)r.x;
  int* outs[4] = {o0, o1, o2, o3};
  const long long at0 = row * N + (long long)tile * kTile;
  for (int e = 4 * t; e < kTile; e += 4 * kFixThreads) {
    const bool all_a = e + 3 < n_left, all_b = e >= from_right;
    if (VEC && (all_a || all_b)) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int x = (int)(all_a ? a[q] : b[q]);
        *reinterpret_cast<int4*>(outs[q] + at0 + e) = make_int4(x, x, x, x);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool in_a = e + i < n_left, in_b = e + i >= from_right;
        if (in_a || in_b) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            outs[q][at0 + e + i] = (int)(in_a ? a[q] : b[q]);
        }
      }
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0u; }

}  // namespace

extern "C" int cl4_run_totals_tile() { return kTile; }

// uint32 of scratch a tile needs (its descriptor)
extern "C" int cl4_run_totals_desc() { return kDesc; }

// key, v1, v2, v3, area, s1, s2, s3: (B, N) int32, key sorted ascending per
// row. desc: B * ceil(N / tile) * cl4_run_totals_desc() int32 of scratch,
// 16-byte aligned.
extern "C" int cl4_run_totals(const int* key, const int* v1, const int* v2,
                              const int* v3, int B, int N, int* area, int* s1,
                              int* s2, int* s3, int* desc, void* stream) {
  if (B < 1 || N < 1 || !aligned16(desc)) return (int)cudaErrorInvalidValue;
  const int n_tiles = (N + kTile - 1) / kTile;
  const long long blocks = (long long)B * n_tiles;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned* d = (unsigned*)desc;
  const bool vec = N % 4 == 0 && aligned16(key) && aligned16(v1) && aligned16(v2) &&
                   aligned16(v3) && aligned16(area) && aligned16(s1) &&
                   aligned16(s2) && aligned16(s3);
  const unsigned grid = (unsigned)blocks;
  if (vec) {
    rt_tile_pass<true><<<grid, kThreads, 0, st>>>(key, v1, v2, v3, N, n_tiles, area,
                                                  s1, s2, s3, d);
    rt_fix_up<true><<<grid, kFixThreads, 0, st>>>(d, N, n_tiles, area, s1, s2, s3);
  } else {
    rt_tile_pass<false><<<grid, kThreads, 0, st>>>(key, v1, v2, v3, N, n_tiles, area,
                                                   s1, s2, s3, d);
    rt_fix_up<false><<<grid, kFixThreads, 0, st>>>(d, N, n_tiles, area, s1, s2, s3);
  }
  return (int)cudaGetLastError();
}
