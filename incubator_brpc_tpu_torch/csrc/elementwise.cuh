// Helpers shared by the elementwise kernels (elementwise.cu, K4 and K4e-b/c/d)
// and the SGD update (update.cu, K4e-a): f32 <-> bf16 with explicit rounding,
// 16-byte vector loads and stores, the walk over a run of elements that
// takes vectors where the pointers allow, and a block-wide f32 or f64 sum in
// a fixed order.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// x rounded to T (round to nearest even), back in f32
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

template <typename T>
constexpr int kVec = 16 / sizeof(T);  // elements in 16 bytes
template <int W>
using Width = std::integral_constant<int, W>;

// W elements at p widened to f32: one 16-byte load when W = kVec<T>
template <int W, typename T>
__device__ __forceinline__ void load(const T* p, float (&f)[W]) {
  if constexpr (W == 1) {
    f[0] = to_f(*p);
  } else {
    static_assert(W == kVec<T>, "a vector is 16 bytes");
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < W; ++i) f[i] = to_f(e[i]);
  }
}

// W f32 values rounded to T and stored at p: one 16-byte store when W = kVec<T>
template <int W, typename T>
__device__ __forceinline__ void store(T* p, const float (&f)[W]) {
  if constexpr (W == 1) {
    *p = from_f<T>(f[0]);
  } else {
    static_assert(W == kVec<T>, "a vector is 16 bytes");
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < W; ++i) e[i] = from_f<T>(f[i]);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

__host__ __device__ __forceinline__ int phase(const void* p) {
  return int(reinterpret_cast<uintptr_t>(p) & 15);
}

// Elements of the pointers' run before the first 16-byte boundary, when all
// of them share one address modulo 16 (null ones aside); else all n (no vectors).
template <typename T>
__host__ __device__ __forceinline__ int64_t head_of(int64_t n, const void* p0, const void* p1,
                                                    const void* p2, const void* p3) {
  const int ph = phase(p0);
  if ((p1 != nullptr && phase(p1) != ph) || (p2 != nullptr && phase(p2) != ph) ||
      (p3 != nullptr && phase(p3) != ph))
    return n;
  const int64_t head = ((16 - ph) & 15) / int(sizeof(T));
  return head < n ? head : n;
}

// Calls f(Width<W>(), c) for each piece [c, c + W) of [0, n) that thread t of
// `stride` threads owns: single elements before `head`, 16-byte vectors after
// it, single elements in the tail. A thread walks the same pieces whenever it
// is called with the same arguments.
template <typename T, typename F>
__device__ __forceinline__ void walk(int64_t n, int64_t head, int64_t t, int64_t stride, F&& f) {
  constexpr int V = kVec<T>;
  for (int64_t c = t; c < head; c += stride) f(Width<1>(), c);
  const int64_t nv = (n - head) / V;
  for (int64_t i = t; i < nv; i += stride) f(Width<V>(), head + i * V);
  for (int64_t c = head + nv * V + t; c < n; c += stride) f(Width<1>(), c);
}

// The sum of v (f32 or f64) over the block, in every thread (each warp
// reduces the warps' partials in the same order, so all get the same value).
// red: 32 values, used by no other block_sum between two barriers.
template <typename V>
__device__ __forceinline__ V block_sum(V v, V* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < int(blockDim.x >> 5) ? red[lane] : V(0);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace
