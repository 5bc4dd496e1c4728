// K4e-a, FabricNet's SGD update over every parameter leaf in one launch,
// hand-written for Hopper (sm_90a):
//
//   sgd_update_multi <- incubator_brpc_tpu/models/fabricnet.py:405, the fused
//                       step's p - cfg.lr * g over the parameter tree, and
//                       :381-391, the sliced schedules' gradient accumulation
//                       and scaled update
//
// Modes, in f32 or bf16 (dtype 0 or 1), a the leaf written in place:
//   0 fused       p = p - round(lr * g)
//   1 accumulate  acc = round(acc + g)                       (slices 1 .. M-2)
//   2 last slice  p = p - round(lr * round(round(acc + g) * inv))
// where lr and inv arrive rounded to the dtype (JAX rounds the weakly typed
// Python float lr, and 1/M, to the parameters' dtype). In bf16 every product
// and sum is rounded to bf16 where the expression rounds (XLA keeps those
// roundings); the product of two bf16 values is exact in f32, so only the
// explicit roundings matter. In f32 XLA:CPU contracts p - lr * h into one
// fused multiply-add, and in the last-slice form it first folds lr * (1/M)
// into one f32 constant: mode 0 is fmaf(-lr, g, p) and mode 2 fmaf(-lr,
// acc + g, p), with the wrapper passing that constant as lr (inv unused).
// __fadd_rn / __fmul_rn / __fsub_rn keep nvcc from contracting anything
// else; the build has no --use_fast_math (ops/kernels.py).
//
// What bounds it on the card: bytes. Modes 0 and 1 read two tensors and
// write one, mode 2 reads three: at the bench_fabricnet width (16 leaves,
// 171,968,512 elements in bf16) 1.03 GB (0.308 ms at 3.35 TB/s) and 1.38 GB
// (0.411 ms). The design streams at HBM's rate across all leaves at once:
// - The leaves' table (pointers, sizes) travels by value in the kernel's
//   parameters (__grid_constant__, under 4 KB: kMaxLeaves leaves a launch;
//   the wrapper splits a longer list), so no host-to-device copy precedes
//   the launch.
// - Each leaf is cut into tiles of kUnitsPerTile 16-byte vectors (elements,
//   for a leaf whose pointers disagree modulo 16); one block takes one tile,
//   finding its leaf by a binary search over the tiles' prefix sums. A leaf's
//   first tile also takes its unaligned head and its tail.
// - Each thread loads its kUnroll vectors of every input before it computes
//   and stores any, so a block keeps 256 x kUnroll loads in flight.
//
// Plain C interface, loaded with ctypes by incubator_brpc_tpu_torch/ops/
// kernels.py and wrapped by ops/update.py. The entry point launches on the
// given stream, allocates nothing, and returns the first CUDA error (0 on
// success).

#include "elementwise.cuh"

namespace {

constexpr int kMaxLeaves = 64;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int64_t kUnitsPerTile = int64_t(kThreads) * kUnroll;

struct Leaf {
  void* a;        // written in place: p (modes 0, 2) or acc (mode 1)
  const void* b;  // g
  const void* c;  // acc (mode 2), else null
  int64_t n;      // elements
  int64_t units;  // vectors after the head (vec), or elements
  int64_t first_tile;
  int32_t head;  // elements before the first 16-byte boundary (vec)
  int32_t vec;
};

struct Table {
  Leaf leaf[kMaxLeaves];
  int32_t count;
  float lr, inv;
};
static_assert(sizeof(Table) <= 4096, "the table travels in the kernel's parameters");

template <typename T, int MODE>
__device__ __forceinline__ float update(float a, float b, float c, float lr, float inv) {
  if constexpr (MODE == 1) {
    return round_to<T>(__fadd_rn(a, b));
  } else if constexpr (std::is_same_v<T, float>) {
    return fmaf(-lr, MODE == 2 ? __fadd_rn(c, b) : b, a);
  } else {
    const float h = MODE == 2 ? round_to<T>(__fmul_rn(round_to<T>(__fadd_rn(c, b)), inv)) : b;
    return round_to<T>(__fsub_rn(a, round_to<T>(__fmul_rn(lr, h))));
  }
}

// Units [u0, u1) of W elements each, from a, b, c: the thread's kUnroll
// units loaded first, then updated and stored.
template <typename T, int MODE, int W>
__device__ __forceinline__ void run(T* __restrict__ a, const T* __restrict__ b,
                                    const T* __restrict__ c, int64_t u0, int64_t u1, float lr,
                                    float inv) {
  float av[kUnroll][W], bv[kUnroll][W], cv[kUnroll][W];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int64_t u = u0 + threadIdx.x + int64_t(k) * kThreads;
    if (u < u1) {
      load<W>(a + u * W, av[k]);
      load<W>(b + u * W, bv[k]);
      if constexpr (MODE == 2) load<W>(c + u * W, cv[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int64_t u = u0 + threadIdx.x + int64_t(k) * kThreads;
    if (u < u1) {
#pragma unroll
      for (int i = 0; i < W; ++i)
        av[k][i] = update<T, MODE>(av[k][i], bv[k][i], MODE == 2 ? cv[k][i] : 0.f, lr, inv);
      store<W>(a + u * W, av[k]);
    }
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads) sgd_update_multi(const __grid_constant__ Table tab) {
  const int64_t tile = blockIdx.x;
  int lo = 0, hi = tab.count - 1;
  while (lo < hi) {  // the last leaf whose first tile is <= this one
    const int mid = (lo + hi + 1) >> 1;
    if (tab.leaf[mid].first_tile <= tile) lo = mid; else hi = mid - 1;
  }
  const Leaf& L = tab.leaf[lo];
  T* a = static_cast<T*>(L.a);
  const T* b = static_cast<const T*>(L.b);
  const T* c = static_cast<const T*>(L.c);
  const int64_t u0 = (tile - L.first_tile) * kUnitsPerTile;
  const int64_t u1 = u0 + kUnitsPerTile < L.units ? u0 + kUnitsPerTile : L.units;
  if (!L.vec) {
    run<T, MODE, 1>(a, b, c, u0, u1, tab.lr, tab.inv);
    return;
  }
  constexpr int V = kVec<T>;
  const int64_t h = L.head;
  run<T, MODE, V>(a + h, b + h, MODE == 2 ? c + h : c, u0, u1, tab.lr, tab.inv);
  if (tile == L.first_tile) {  // the head, then the tail: fewer than V elements each
    const int64_t tail = h + L.units * V + (int64_t(threadIdx.x) - h);
    const int64_t i = threadIdx.x < h ? int64_t(threadIdx.x) : tail < L.n ? tail : -1;
    if (i >= 0) {
      const float cv = MODE == 2 ? to_f(c[i]) : 0.f;
      a[i] = from_f<T>(update<T, MODE>(to_f(a[i]), to_f(b[i]), cv, tab.lr, tab.inv));
    }
  }
}

template <typename T>
cudaError_t launch(const Table& tab, int64_t tiles, int mode, cudaStream_t st) {
  const unsigned grid = unsigned(tiles);
  if (mode == 0)
    sgd_update_multi<T, 0><<<grid, kThreads, 0, st>>>(tab);
  else if (mode == 1)
    sgd_update_multi<T, 1><<<grid, kThreads, 0, st>>>(tab);
  else
    sgd_update_multi<T, 2><<<grid, kThreads, 0, st>>>(tab);
  return cudaGetLastError();
}

// The table of the non-empty leaves; returns the tiles they take.
template <typename T>
int64_t fill(Table& tab, void* const* a, const void* const* b, const void* const* c,
             const int64_t* n, int count, int mode) {
  constexpr int V = kVec<T>;
  int64_t tiles = 0;
  tab.count = 0;
  for (int i = 0; i < count; ++i) {
    if (n[i] <= 0) continue;
    Leaf& L = tab.leaf[tab.count++];
    L.a = a[i];
    L.b = b[i];
    L.c = mode == 2 ? c[i] : nullptr;
    L.n = n[i];
    const int64_t head = head_of<T>(L.n, L.a, L.b, L.c, nullptr);
    L.vec = head < L.n;  // else single elements, all n
    L.head = L.vec ? int32_t(head) : 0;
    L.units = L.vec ? (L.n - head) / V : L.n;
    L.first_tile = tiles;
    const int64_t t = (L.units + kUnitsPerTile - 1) / kUnitsPerTile;
    tiles += t > 0 ? t : 1;
  }
  return tiles;
}

}  // namespace

extern "C" {

// Leaf i: a[i] (written), b[i] and, in mode 2, c[i], each n[i] elements of
// the dtype; count <= 64 leaves; lr and inv already in the dtype (mode 2 in
// f32: lr = f32(lr * (1/M)), inv unused).
int tb_sgd_update_multi(void* const* a, const void* const* b, const void* const* c,
                        const int64_t* n, int count, int mode, int dtype, float lr, float inv,
                        void* stream) {
  if (count < 0 || count > kMaxLeaves || mode < 0 || mode > 2 || (dtype != 0 && dtype != 1) ||
      (mode == 2 && c == nullptr))
    return int(cudaErrorInvalidValue);
  Table tab;
  tab.lr = lr;
  tab.inv = inv;
  const int64_t tiles = dtype == 0 ? fill<float>(tab, a, b, c, n, count, mode)
                                   : fill<__nv_bfloat16>(tab, a, b, c, n, count, mode);
  if (tiles == 0) return 0;
  if (tiles > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(dtype == 0 ? launch<float>(tab, tiles, mode, st)
                        : launch<__nv_bfloat16>(tab, tiles, mode, st));
}

}  // extern "C"
