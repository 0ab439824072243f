// Connected components over batched planes, in two forms that share the
// union-find passes below: multilabel (int32 classes; every pixel with class
// > 0 gets the smallest flat index of its same-class component, 4- or
// 8-connected) and binary (a byte mask; every nonzero pixel gets the smallest
// flat index of its component). Background gets H*W in both.
//
// Replaces cl4wsis_tpu/ops/pallas_cc.py::connected_components_multilabel_pallas
// and ::connected_components_pallas, which keep a whole plane in VMEM and
// sweep segmented min-scans to a fixpoint under an iteration cap of
// max(num_iters, 4(H+W)). Here the plane stays in device memory and the
// labels are union-find trees, in the style of Playne and Hawick (2018) and
// Komura (2015), built in three passes:
//   local:    one block per 32 x 32 tile of one plane loads the tile's
//             classes into shared memory, links each row's runs of
//             same-class pixels to their first pixel (one warp ballot a
//             row) and unites runs with the same-class runs they touch in
//             the row above (at 8-connectivity also diagonally) in a
//             shared-memory forest, then writes each pixel's label as the
//             flat index of its tile-local root (background: H*W);
//   border:   only the pixels whose earlier neighbours lie in another tile
//             (a tile's top row and left column, and at 8-connectivity its
//             right column: 6 % or 9 % of the pixels) unite across tiles,
//             on the labels in device memory, and only where no
//             neighbouring border pixel makes the same union;
//   compress: L[i] = find(i) for every pixel that is not a root.
// A union links the larger root under the smaller one with atomicMin and
// retries if another thread moved the root first. Row-major order inside a
// tile is the plane's flat order restricted to the tile, so in both forests
// every parent pointer names a smaller index of the same component, and
// the root of each finished tree is its smallest index whatever order the
// threads ran in: the output is exact and deterministic, and there is no
// iteration cap (the JAX fixpoint needed one only for adversarial spirals).
//
// The binary form reads the mask bytes directly: no pass converts them to
// int32 first.
//
// Bound on the H100: bytes. One 512 x 512 plane reads 1 MB of classes (or
// 256 KB of mask) and writes 1 MB of roots: 0.63 us (0.39 us) at 3.35 TB/s.
// The passes read the classes once in the local pass (plus the border
// pixels' neighbours), write the labels once, and the compress pass reads
// them once more and rewrites only the pixels that are not roots. Nearly
// all unions happen in shared memory, so the global atomics and pointer
// chases are left to the border pixels; find() halves paths as it walks, so
// the dependent chains stay short even in one component that covers the
// plane.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Root of x, read only: the local pass uses it after its unions, and the
// compress pass, where every node's entry is written by its own thread
// alone.
__device__ __forceinline__ int find_root(const int* l, int x) {
  const volatile int* vl = l;
  int p = vl[x];
  while (p != x) {
    x = p;
    p = vl[x];
  }
  return x;
}

// Root of x, halving the path on the way (unions in shared memory and in
// device memory alike): each visited node is pointed at its grandparent
// with a plain store. A node never becomes a root again once linked, and
// the store always names a smaller index of the same tree, so it cannot
// undo a link that completed a union; it may undo a concurrent atomicMin
// on a node that was no longer a root, whose caller goes on to unite with
// that node's tree itself.
__device__ __forceinline__ int find_halving(int* l, int x) {
  volatile int* vl = l;
  while (true) {
    const int p = vl[x];
    if (p == x) return x;
    const int gp = vl[p];
    if (gp != p) vl[x] = gp;
    x = gp;
  }
}

__device__ void unite(int* l, int a, int b) {
  while (true) {
    a = find_halving(l, a);
    b = find_halving(l, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    // hang root b under a; if b stopped being a root meanwhile, its new
    // parent must join a's tree too
    const int old = atomicMin(&l[b], a);
    if (old == b) return;
    b = old;
  }
}

// What a pixel is and which neighbours it joins. Classes: int32, class > 0
// is foreground and joins equal classes. Masks: bytes (bool or uint8),
// read as they are: nonzero is foreground and joins any foreground.
struct ClassRule {
  typedef int T;
  __device__ static bool fg(int v) { return v > 0; }
  __device__ static bool joins(int v, int u) { return u == v; }
};

struct MaskRule {
  typedef uint8_t T;
  __device__ static bool fg(uint8_t v) { return v != 0; }
  __device__ static bool joins(uint8_t, uint8_t u) { return u != 0; }
};

constexpr int kTile = 32;            // tiles are kTile x kTile pixels
constexpr int kWarpsLocal = 8;       // warps of the local pass
constexpr int kRows = kTile / kWarpsLocal;   // tile rows a warp takes
constexpr int kBorderThreads = 128;  // >= 3 kTile - 2 border pixels a tile

// Local pass: grid (tiles across, tiles down, planes), kWarpsLocal warps,
// each taking every kWarpsLocal-th row of the tile, one lane per column;
// every thread issues its kRows loads before any other work. Each row's
// runs (maximal horizontal stretches of pixels that join) come from one
// ballot: every pixel's parent is its run's first pixel. Then a pixel
// unites its run with the row above only where the run meets a run there
// that no pixel to its left in the same run has met already (two
// neighbours above that both join are in one run), so a tile takes a few
// unions per run instead of up to four per pixel.
template <class R>
__global__ void __launch_bounds__(kTile * kWarpsLocal)
cc_local(const typename R::T* __restrict__ cls, int* __restrict__ labels,
         int H, int W, int connectivity) {
  typedef typename R::T T;
  __shared__ T c[kTile][kTile];
  __shared__ int l[kTile * kTile];
  const int lx = threadIdx.x % kTile, w = threadIdx.x / kTile;
  const int x = blockIdx.x * kTile + lx;
  const long long plane = (long long)blockIdx.z * H * W;
  // pixels outside the plane read as background: they join nothing
  T v[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int y = blockIdx.y * kTile + w + r * kWarpsLocal;
    v[r] = (x < W && y < H) ? cls[plane + (long long)y * W + x] : T(0);
  }
  unsigned same_left = 0;   // bit r: row r's pixel joins its left one
  int run[kRows];           // index of the first pixel of the pixel's run
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int ly = w + r * kWarpsLocal;
    const bool fg = R::fg(v[r]);
    const T left = __shfl_up_sync(0xffffffffu, v[r], 1);
    const bool same = fg && lx > 0 && R::joins(v[r], left);
    const unsigned starts = __ballot_sync(0xffffffffu, fg && !same);
    same_left |= (unsigned)same << r;
    c[ly][lx] = v[r];
    run[r] = ly * kTile + (fg ? 31 - __clz(starts & ((2u << lx) - 1u)) : lx);
    l[ly * kTile + lx] = run[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int ly = w + r * kWarpsLocal;
    const int i = ly * kTile + lx;
    if (!R::fg(v[r]) || ly == 0) continue;
    const bool same = (same_left >> r) & 1u;
    const bool up = R::joins(v[r], c[ly - 1][lx]);
    const bool up_left = lx > 0 && R::joins(v[r], c[ly - 1][lx - 1]);
    if (connectivity == 4) {
      if (up && !(same && up_left)) unite(l, run[r], i - kTile);
    } else {
      // up-left and up joining are one run above: take one of them
      const bool up_right =
          lx < kTile - 1 && R::joins(v[r], c[ly - 1][lx + 1]);
      if (!same && (up_left || up))
        unite(l, run[r], up_left ? i - kTile - 1 : i - kTile);
      if (up_right && !up) unite(l, run[r], i - kTile + 1);
    }
  }
  __syncthreads();
  // The first pixel of every run points at its root directly (a walk that
  // meets a run already done takes one more step), then every pixel reads
  // its root there.
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = (w + r * kWarpsLocal) * kTile + lx;
    if (R::fg(v[r]) && run[r] == i) l[i] = find_root(l, i);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int y = blockIdx.y * kTile + w + r * kWarpsLocal;
    if (x >= W || y >= H) continue;
    int out = H * W;
    if (R::fg(v[r])) {
      const int root = l[run[r]];
      out = (blockIdx.y * kTile + root / kTile) * W + blockIdx.x * kTile +
            root % kTile;
    }
    labels[plane + (long long)y * W + x] = out;
  }
}

// Border pass: grid as the local pass, one thread per border pixel of a
// tile: the top row, the left column and, at 8-connectivity, the right
// column (whose up-right neighbour lies in the next tile). Each unites with
// its earlier same-class neighbours that lie in another tile, skipping a
// union that others already make: on the top row as in the local pass; on
// the left column the left neighbour when the pixel above joins both this
// pixel and the up-left one (the two columns are joined a row higher), and
// likewise the diagonals.
template <class R>
__global__ void __launch_bounds__(kBorderThreads)
cc_border(const typename R::T* __restrict__ cls, int* labels, int H, int W,
          int connectivity) {
  const int t = threadIdx.x;
  int ly, lx;
  if (t < kTile) {
    ly = 0;
    lx = t;
  } else if (t < 2 * kTile - 1) {
    ly = t - kTile + 1;
    lx = 0;
  } else if (t < 3 * kTile - 2 && connectivity == 8) {
    ly = t - 2 * kTile + 2;
    lx = kTile - 1;
  } else {
    return;
  }
  const int y = blockIdx.y * kTile + ly, x = blockIdx.x * kTile + lx;
  if (y >= H || x >= W) return;
  const long long plane = (long long)blockIdx.z * H * W;
  const typename R::T* c = cls + plane;
  int* l = labels + plane;
  const int i = y * W + x;
  const typename R::T v = c[i];
  if (!R::fg(v)) return;
  const bool left = x > 0 && R::joins(v, c[i - 1]);
  const bool up = y > 0 && R::joins(v, c[i - W]);
  const bool up_left = x > 0 && y > 0 && R::joins(v, c[i - W - 1]);
  const bool up_right = x < W - 1 && y > 0 && R::joins(v, c[i - W + 1]);
  if (ly == 0) {
    // the row above lies in another tile
    if (connectivity == 4) {
      if (up && !(left && up_left)) unite(l, i, i - W);
    } else {
      if (!left) {
        if (up_left) unite(l, i, i - W - 1);
        if (up && !up_left) unite(l, i, i - W);
      }
      if (up_right && !up) unite(l, i, i - W + 1);
    }
  }
  if (lx == 0) {
    // the column to the left lies in another tile
    if (left && !(ly > 0 && up && up_left)) unite(l, i, i - 1);
    if (connectivity == 8 && ly > 0 && up_left && !up && !left)
      unite(l, i, i - W - 1);
  }
  if (lx == kTile - 1 && ly > 0 && up_right && !up &&
      !(x < W - 1 && R::joins(v, c[i + 1])))
    unite(l, i, i - W + 1);   // 8-connectivity: the next tile, a row up
}

// Compress pass: background (H*W) and roots stay; every other pixel gets
// its root. Only this pixel's thread writes its entry, and it writes a
// node of the same path, so concurrent finds still reach the same root.
__global__ void cc_compress(int* labels, long long total, int hw) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= total) return;
  const long long plane = g / hw;
  const int i = (int)(g - plane * hw);
  int* l = labels + plane * hw;
  const int p = l[i];
  if (p == hw || p == i) return;
  const int r = find_root(l, p);
  if (r != p) l[i] = r;
}

template <class R>
int launch_cc(const typename R::T* cls, int* roots, int N, int H, int W,
              int connectivity, void* stream) {
  if (N < 1 || H < 1 || W < 1 || (long long)H * W >= 0x7FFFFFFFll ||
      N > 65535 || (connectivity != 4 && connectivity != 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int hw = H * W;
  const long long total = (long long)N * hw;
  const dim3 tiles((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, N);
  cc_local<R><<<tiles, kTile * kWarpsLocal, 0, st>>>(cls, roots, H, W,
                                                     connectivity);
  cc_border<R><<<tiles, kBorderThreads, 0, st>>>(cls, roots, H, W,
                                                 connectivity);
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  cc_compress<<<blocks, kThreads, 0, st>>>(roots, total, hw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* cl4_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The library links its own CUDA runtime, whose current device is separate
// from PyTorch's: the wrappers set it to the tensors' device before a launch.
extern "C" int cl4_set_device(int device) { return (int)cudaSetDevice(device); }

// cls, roots: (N, H, W) int32, contiguous. connectivity: 4 or 8.
extern "C" int cl4_cc_multilabel(const int* cls, int* roots, int N, int H, int W,
                                 int connectivity, void* stream) {
  return launch_cc<ClassRule>(cls, roots, N, H, W, connectivity, stream);
}

// mask: (N, H, W) bytes (a bool or uint8 tensor), contiguous; roots: (N, H, W)
// int32. Replaces cl4wsis_tpu/ops/pallas_cc.py::connected_components_pallas.
extern "C" int cl4_cc_binary(const uint8_t* mask, int* roots, int N, int H, int W,
                             int connectivity, void* stream) {
  return launch_cc<MaskRule>(mask, roots, N, H, W, connectivity, stream);
}
