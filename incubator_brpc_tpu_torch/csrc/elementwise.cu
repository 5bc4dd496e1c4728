// K4, FabricNet's elementwise chain, hand-written for Hopper (sm_90a):
//
//   add_rms_norm_fwd  <- incubator_brpc_tpu/models/fabricnet.py:119 _rms_norm,
//                        with the residual add of _stage_fn (:193-209) whose
//                        sum it reads: s = x + delta, n = s * rsqrt(mean(s^2)
//                        + 1e-6) over each row, and the row's rsqrt (rstd)
//   rms_norm_bwd      <- the gradient JAX's autodiff takes through _rms_norm,
//                        g = r g_n - (r^3 / d) s sum(g_n s), plus the residual
//                        stream's own gradient g_s
//   gelu_tanh_fwd     <- :123 _gelu (jax.nn.gelu, the tanh form)
//   gelu_tanh_bwd     <- its gradient
//
// Rows are the last dimension of a row-major tensor, rows * d elements from
// the base pointer; f32 or bf16 (dtype 0 or 1), computed in f32. Each
// kernel rounds where its plain version in ops/elementwise.py rounds:
// - add_rms_norm_fwd: s rounded to the dtype; each square rounded to the
//   dtype and summed in f32; the mean (the sum times 1/d, as PyTorch's mean
//   on the card forms it) rounded to the dtype, + 1e-6 rounded, rsqrtf (as
//   torch.rsqrt) rounded; n = s * r rounded. Only the row sum's order
//   differs from the plain version's.
// - rms_norm_bwd: f32 throughout, one rounding out; sum(g_n s) in another
//   order than the plain version's.
// - gelu_tanh_fwd / _bwd: PyTorch's own tanh GeLU and GeLU backward
//   expressions (ATen's GeluCUDAKernelImpl and GeluBackwardCUDAKernelImpl),
//   the same constants and tanhf, left to nvcc's default contraction as
//   PyTorch's build leaves them, one rounding out.
// The intrinsics __fadd_rn / __fmul_rn / __fsub_rn / __fdiv_rn keep nvcc
// from contracting the norm's products and sums into FMAs that the plain
// version does not take. The build has no --use_fast_math (ops/kernels.py).
//
// What bounds them on the card: bytes. Each does a few operations per
// element it reads (the GeLUs a tanhf), far below the card's 295 operations
// per byte. The design is the simple one that streams at HBM's rate:
// - 16-byte loads and stores (4 f32 or 8 bf16), where every pointer of the
//   row (or of the tensor) has the same address modulo 16; single elements
//   before the first 16-byte boundary and after the last, and for a row
//   whose pointers disagree (an odd width, a view one element into a
//   buffer). Any width is taken.
// - The norms put one block on one row: pass 1 reads the row and reduces in
//   f32 (warp shuffles, then the warps' partials through shared memory),
//   pass 2 reads the row again, from L2 (a 2048-wide bf16 row is 4 KB), and
//   writes it. rms_norm_bwd reads rstd rather than recomputing the rsqrt.
// - The GeLUs are grid-stride loops over the elements.
//
// Plain C interface, loaded with ctypes by incubator_brpc_tpu_torch/ops/
// kernels.py and wrapped by ops/elementwise.py. Every entry point launches
// on the given stream, allocates nothing, and returns the first CUDA error
// (0 on success).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int kMaxNormThreads = 512;
constexpr int kEltThreads = 256;
constexpr int64_t kMaxEltBlocks = 132 * 16;  // 16 blocks of 256 threads an SM
// PyTorch's constants: M_SQRT2 * M_2_SQRTPI * 0.5 rounded once to f32, and 0.044715
constexpr float kBeta = float(1.41421356237309504880 * 1.12837916709551257390 * 0.5);
constexpr float kKappa = float(0.044715);

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

__device__ __forceinline__ int phase(const void* p) {
  return int(reinterpret_cast<uintptr_t>(p) & 15);
}

// Elements of the pointers' run before the first 16-byte boundary, when all
// of them share one address modulo 16 (null ones aside); else all n (no vectors).
template <typename T>
__device__ __forceinline__ int64_t head_of(int64_t n, const void* p0, const void* p1,
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

// The sum of v over the block, in every thread (each warp reduces the warps'
// partials in the same order, so all get the same value). red: 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < int(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// -- K4a: s = x + delta, n = s * rsqrt(mean(s^2) + 1e-6), rstd --------------------
// One block a row. delta and s are both null (s is x) or both set. Pass 2
// reads back the s this thread wrote in pass 1 (the same pieces), so no
// pointer is __restrict__.
template <typename T>
__global__ void add_rms_norm_fwd(const T* x, const T* delta, T* s, T* n, float* rstd,
                                 int64_t d) {
  __shared__ float red[32];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  const T* dr = delta ? delta + row * d : nullptr;
  T* sr = delta ? s + row * d : nullptr;
  T* nr = n + row * d;
  const int64_t head = head_of<T>(d, xr, dr, sr, nr);
  float sq = 0.f;
  walk<T>(d, head, threadIdx.x, blockDim.x, [&](auto w, int64_t c) {
    constexpr int W = decltype(w)::value;
    float a[W];
    load<W>(xr + c, a);
    if (dr != nullptr) {
      float b[W];
      load<W>(dr + c, b);
#pragma unroll
      for (int i = 0; i < W; ++i) a[i] = round_to<T>(__fadd_rn(a[i], b[i]));
      store<W>(sr + c, a);
    }
#pragma unroll
    for (int i = 0; i < W; ++i) sq = __fadd_rn(sq, round_to<T>(__fmul_rn(a[i], a[i])));
  });
  const float mean = round_to<T>(__fmul_rn(block_sum(sq, red), 1.0f / float(d)));
  const float r = round_to<T>(rsqrtf(round_to<T>(__fadd_rn(mean, 1e-6f))));
  if (threadIdx.x == 0) rstd[row] = r;
  const T* src = dr != nullptr ? sr : xr;
  walk<T>(d, head, threadIdx.x, blockDim.x, [&](auto w, int64_t c) {
    constexpr int W = decltype(w)::value;
    float a[W];
    load<W>(src + c, a);
#pragma unroll
    for (int i = 0; i < W; ++i) a[i] = __fmul_rn(a[i], r);
    store<W>(nr + c, a);
  });
}

// -- K4b: g = r g_n - (r^3 / d) s sum(g_n s) (+ g_s) --------------------------------
// One block a row; g_s may be null.
template <typename T>
__global__ void rms_norm_bwd(const T* __restrict__ s, const float* __restrict__ rstd,
                             const T* __restrict__ gn, const T* __restrict__ gs,
                             T* __restrict__ g, int64_t d) {
  __shared__ float red[32];
  const int64_t row = blockIdx.x;
  const T* sr = s + row * d;
  const T* nr = gn + row * d;
  const T* gsr = gs ? gs + row * d : nullptr;
  T* gr = g + row * d;
  const int64_t head = head_of<T>(d, sr, nr, gsr, gr);
  float dot = 0.f;
  walk<T>(d, head, threadIdx.x, blockDim.x, [&](auto w, int64_t c) {
    constexpr int W = decltype(w)::value;
    float a[W], b[W];
    load<W>(sr + c, a);
    load<W>(nr + c, b);
#pragma unroll
    for (int i = 0; i < W; ++i) dot = __fadd_rn(dot, __fmul_rn(b[i], a[i]));
  });
  const float r = rstd[row];
  const float coef =
      __fmul_rn(__fmul_rn(__fmul_rn(r, r), r), __fdiv_rn(block_sum(dot, red), float(d)));
  walk<T>(d, head, threadIdx.x, blockDim.x, [&](auto w, int64_t c) {
    constexpr int W = decltype(w)::value;
    float a[W], b[W];
    load<W>(sr + c, a);
    load<W>(nr + c, b);
#pragma unroll
    for (int i = 0; i < W; ++i) b[i] = __fsub_rn(__fmul_rn(r, b[i]), __fmul_rn(coef, a[i]));
    if (gsr != nullptr) {
      load<W>(gsr + c, a);
#pragma unroll
      for (int i = 0; i < W; ++i) b[i] = __fadd_rn(b[i], a[i]);
    }
    store<W>(gr + c, b);
  });
}

// -- K4c / K4d: the tanh GeLU and its gradient -------------------------------------

__device__ __forceinline__ float gelu_f(float x) {
  const float x_cube = x * x * x;
  const float inner = kBeta * (x + kKappa * x_cube);
  return 0.5f * x * (1.0f + tanhf(inner));
}

__device__ __forceinline__ float gelu_bwd_f(float dy, float x) {
  const float x_sq = x * x;
  const float x_cube = x_sq * x;
  const float inner = kBeta * (x + kKappa * x_cube);
  const float tanh_inner = tanhf(inner);
  const float left = 0.5f * x;
  const float right = 1.0f + tanh_inner;
  const float left_derivative = 0.5f * right;
  const float tanh_derivative = 1.0f - tanh_inner * tanh_inner;
  const float inner_derivative = kBeta * (1.0f + 3.0f * kKappa * x_sq);
  const float right_derivative = left * tanh_derivative * inner_derivative;
  return dy * (left_derivative + right_derivative);
}

template <typename T>
__global__ void gelu_tanh_fwd(const T* __restrict__ x, T* __restrict__ y, int64_t n) {
  const int64_t head = head_of<T>(n, x, y, nullptr, nullptr);
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  walk<T>(n, head, t, int64_t(gridDim.x) * blockDim.x, [&](auto w, int64_t c) {
    constexpr int W = decltype(w)::value;
    float a[W];
    load<W>(x + c, a);
#pragma unroll
    for (int i = 0; i < W; ++i) a[i] = gelu_f(a[i]);
    store<W>(y + c, a);
  });
}

template <typename T>
__global__ void gelu_tanh_bwd(const T* __restrict__ x, const T* __restrict__ dy,
                              T* __restrict__ dx, int64_t n) {
  const int64_t head = head_of<T>(n, x, dy, dx, nullptr);
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  walk<T>(n, head, t, int64_t(gridDim.x) * blockDim.x, [&](auto w, int64_t c) {
    constexpr int W = decltype(w)::value;
    float a[W], b[W];
    load<W>(x + c, a);
    load<W>(dy + c, b);
#pragma unroll
    for (int i = 0; i < W; ++i) a[i] = gelu_bwd_f(b[i], a[i]);
    store<W>(dx + c, a);
  });
}

// -- launches -----------------------------------------------------------------------

// threads for one row of d: a 16-byte piece each, in whole warps, 32 to 512
template <typename T>
unsigned norm_threads(int64_t d) {
  const int64_t pieces = (d + kVec<T> - 1) / kVec<T>;
  const int64_t t = (pieces + 31) / 32 * 32;
  return unsigned(t < 32 ? 32 : t > kMaxNormThreads ? kMaxNormThreads : t);
}

unsigned elt_blocks(int64_t n, int vec) {
  const int64_t blocks = (n / vec + kEltThreads) / kEltThreads;
  return unsigned(blocks < kMaxEltBlocks ? blocks : kMaxEltBlocks);
}

bool rows_ok(int64_t rows, int64_t d, int dtype) {
  return rows > 0 && rows <= 0x7fffffffLL && d > 0 && (dtype == 0 || dtype == 1);
}

}  // namespace

extern "C" {

// x, delta, s, n: [rows, d]; rstd: [rows] f32. delta and s both null or both set.
int tb_add_rms_norm_fwd(const void* x, const void* delta, void* s, void* n, float* rstd,
                        int64_t rows, int64_t d, int dtype, void* stream) {
  if (!rows_ok(rows, d, dtype) || (delta == nullptr) != (s == nullptr))
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    add_rms_norm_fwd<float><<<unsigned(rows), norm_threads<float>(d), 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(delta), static_cast<float*>(s),
        static_cast<float*>(n), rstd, d);
  else
    add_rms_norm_fwd<__nv_bfloat16><<<unsigned(rows), norm_threads<__nv_bfloat16>(d), 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(delta),
        static_cast<__nv_bfloat16*>(s), static_cast<__nv_bfloat16*>(n), rstd, d);
  return int(cudaGetLastError());
}

// s, g_n, g_s, g: [rows, d]; rstd: [rows] f32. g_s may be null.
int tb_rms_norm_bwd(const void* s, const float* rstd, const void* gn, const void* gs, void* g,
                    int64_t rows, int64_t d, int dtype, void* stream) {
  if (!rows_ok(rows, d, dtype)) return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    rms_norm_bwd<float><<<unsigned(rows), norm_threads<float>(d), 0, st>>>(
        static_cast<const float*>(s), rstd, static_cast<const float*>(gn),
        static_cast<const float*>(gs), static_cast<float*>(g), d);
  else
    rms_norm_bwd<__nv_bfloat16><<<unsigned(rows), norm_threads<__nv_bfloat16>(d), 0, st>>>(
        static_cast<const __nv_bfloat16*>(s), rstd, static_cast<const __nv_bfloat16*>(gn),
        static_cast<const __nv_bfloat16*>(gs), static_cast<__nv_bfloat16*>(g), d);
  return int(cudaGetLastError());
}

// x, y: n elements
int tb_gelu_tanh_fwd(const void* x, void* y, int64_t n, int dtype, void* stream) {
  if (n <= 0 || (dtype != 0 && dtype != 1)) return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    gelu_tanh_fwd<float><<<elt_blocks(n, kVec<float>), kEltThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n);
  else
    gelu_tanh_fwd<__nv_bfloat16><<<elt_blocks(n, kVec<__nv_bfloat16>), kEltThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), n);
  return int(cudaGetLastError());
}

// x, dy, dx: n elements
int tb_gelu_tanh_bwd(const void* x, const void* dy, void* dx, int64_t n, int dtype,
                     void* stream) {
  if (n <= 0 || (dtype != 0 && dtype != 1)) return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    gelu_tanh_bwd<float><<<elt_blocks(n, kVec<float>), kEltThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), static_cast<float*>(dx), n);
  else
    gelu_tanh_bwd<__nv_bfloat16><<<elt_blocks(n, kVec<__nv_bfloat16>), kEltThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy),
        static_cast<__nv_bfloat16*>(dx), n);
  return int(cudaGetLastError());
}

}  // extern "C"
