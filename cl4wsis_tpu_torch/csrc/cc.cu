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
// Komura (2015):
//   init:     L[i] = i;
//   merge:    each foreground pixel unites with its earlier same-class
//             neighbours (left and up; at 8-connectivity also up-left and
//             up-right). A union links the larger root under the smaller one
//             with atomicMin and retries if another thread moved the root
//             first;
//   compress: L[i] = find(i), background written as H*W.
// Every parent pointer names a smaller index of the same component, so the
// root of each finished tree is its smallest index whatever order the
// threads ran in:
// the output is exact and deterministic, and there is no iteration cap (the
// JAX fixpoint needed one only for adversarial spirals).
//
// The binary form reads the mask bytes directly: no pass converts them to
// int32 first.
//
// Bound on the H100: bytes. One 512 x 512 plane reads 1 MB of classes (or
// 256 KB of mask) and writes 1 MB of roots: 0.63 us (0.39 us) at 3.35 TB/s.
// The three passes read the classes twice and the labels a few times more;
// find() halves paths
// as it walks, so the dependent chains stay short even in one component
// that covers the plane. A later change can unite within a tile in shared
// memory first so that fewer global atomics remain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Root of x, read only: the compress pass uses it, where every node's entry
// is written by its own thread alone.
__device__ __forceinline__ int find_root(const int* l, int x) {
  const volatile int* vl = l;
  int p = vl[x];
  while (p != x) {
    x = p;
    p = vl[x];
  }
  return x;
}

// Root of x, halving the path on the way (merge pass): each visited node is
// pointed at its grandparent with a plain store. A node never becomes a root
// again once linked, and the store always names a smaller index of the same
// tree, so it cannot undo a link that completed a union; it may undo a
// concurrent atomicMin on a node that was no longer a root, whose caller
// goes on to unite with that node's tree itself.
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

__global__ void cc_init(int* labels, long long total, int hw) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g < total) labels[g] = (int)(g % hw);
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

template <class R>
__global__ void cc_merge(const typename R::T* __restrict__ cls, int* labels,
                         long long total, int H, int W, int connectivity) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= total) return;
  const int hw = H * W;
  const long long plane = g / hw;
  const int i = (int)(g - plane * hw);
  const typename R::T* c = cls + plane * hw;
  int* l = labels + plane * hw;
  const typename R::T v = c[i];
  if (!R::fg(v)) return;
  const int y = i / W, x = i - (i / W) * W;
  if (x > 0 && R::joins(v, c[i - 1])) unite(l, i, i - 1);
  if (y > 0) {
    if (R::joins(v, c[i - W])) unite(l, i, i - W);
    if (connectivity == 8) {
      if (x > 0 && R::joins(v, c[i - W - 1])) unite(l, i, i - W - 1);
      if (x < W - 1 && R::joins(v, c[i - W + 1])) unite(l, i, i - W + 1);
    }
  }
}

template <class R>
__global__ void cc_compress(const typename R::T* __restrict__ cls, int* labels,
                            long long total, int hw) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= total) return;
  const long long plane = g / hw;
  const int i = (int)(g - plane * hw);
  int* l = labels + plane * hw;
  // no find() ever reaches a background pixel, so overwriting it is safe
  l[i] = R::fg(cls[g]) ? find_root(l, i) : hw;
}

template <class R>
int launch_cc(const typename R::T* cls, int* roots, int N, int H, int W,
              int connectivity, void* stream) {
  if (N < 1 || H < 1 || W < 1 || (long long)H * W >= 0x7FFFFFFFll ||
      (connectivity != 4 && connectivity != 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int hw = H * W;
  const long long total = (long long)N * hw;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  cc_init<<<blocks, kThreads, 0, st>>>(roots, total, hw);
  cc_merge<R><<<blocks, kThreads, 0, st>>>(cls, roots, total, H, W, connectivity);
  cc_compress<R><<<blocks, kThreads, 0, st>>>(cls, roots, total, hw);
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
