// K3's backward on the ring-attention path, hand-written for Hopper (sm_90a):
//
//   attn_bwd_delta  <- the gradient JAX's autodiff takes through ring_attention
//                      (lax.scan over block_merge), by recomputation: its
//                      delta = rowsum(dO * O). dK/dV and dQ are
//                      attn_bwd_dkdv_tc and attn_bwd_dq_tc for bf16 operands
//                      (attention_bwd_tc.cu, tensor cores) and
//                      attn_bwd_dkdv_tf32 and attn_bwd_dq_tf32
//                      (attention_bwd_tf32.cu, 3xTF32 on the tensor cores)
//                      for f32 ones.
//
// Tensors keep JAX's layout: q, k, v, out, dout, dq, dk, dv are (B, T, H, D)
// in f32 or bf16; the softmax statistics m, l, lse and delta are (B, H, T)
// f32; the running sum o is (B, T, H, D) f32. The ring is sp ranks on one
// card: rank i owns the rows [i*T/sp, (i+1)*T/sp), and at hop r it folds
// the key/value block of rank src = (i - r) mod sp. The forward fold is
// attn_fold_fwd_tf32 (attention_tf32.cu) for f32 operands and
// attn_fold_fwd_tc (attention_tc.cu) for bf16: their products run on the
// tensor cores, their scale, mask and softmax are the ones stated here.
//
// Numerics follow the JAX function, not a flash library: operands are
// widened to f32, and where a product runs on the tensor cores its f32
// operands (P, dS, and f32 inputs) are split so that the result keeps f32's
// precision (attention_tc.cu, attention_tf32.cu); the scale is a
// division by sqrtf(Dscale), the head dimension before the zero columns that
// the wrappers add to a D % 4 != 0 (every kernel of K3 takes the padded D
// and the true one); the causal mask is an additive -1e30 from global
// positions, and the running max starts at -1e30, so alpha = exp(m - m_new)
// is 0 (not NaN) on the first fold. Keys past a ragged block end do not
// exist and weigh 0. A key tile that lies wholly in a row tile's future is
// skipped: for every row the first tile folded (hop 0, the diagonal block,
// key 0) holds a visible key, so such a tile would add exp(-1e30 - m) = 0.
//
// What bounds attn_bwd_delta on the card: bytes (one multiply-add an
// element read). It has two forms, and the wrapper (ops/attention.py
// row_dot, delta_form) picks one from the shape before the launch:
//
//   vector   rows on 16-byte boundaries (both tensors 16-byte aligned and
//            D * itemsize % 16 == 0) and B*T*H*D < 2^31. A group of L lanes
//            owns a row, L the largest power of two <= 32 and <= the row's
//            16-byte vectors (a warp a row at D = 1024, 2 lanes a row and 16
//            rows a warp at bf16 D = 16). Each lane issues every uint4 load
//            of its turn, kVecTurn vectors of out and of dout, before its
//            first FMA (at bf16 D = 1024 that is all of its 4 + 4: 128 B in
//            flight a lane), on the read-only path with evict-first (nothing
//            reads them again), then widens to f32 and accumulates in a fixed
//            order, its vectors in order and each vector's elements in order;
//            the group sums its lanes' partials with a butterfly
//            (__shfl_xor_sync within the group). 32-bit indices.
//   general  any other row: one warp a row, one element of each tensor a
//            lane a turn, 64-bit indices: the kernel's first form.
//
// Plain C interface, loaded with ctypes by incubator_brpc_tpu_torch/ops/
// kernels.py. Every entry point launches on the given stream, allocates
// nothing, and returns the first CUDA error (0 on success).

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Geo {
  int64_t B, T, H, D;
};

// offset of (b, h, t) of a (B, H, T) statistic
__device__ __forceinline__ int64_t stat_off(const Geo& g, int64_t b, int64_t h, int64_t t) {
  return (b * g.H + h) * g.T + t;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// Backward. delta = rowsum(dO * O) in f32, one warp per row.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_delta(const T* __restrict__ out, const T* __restrict__ dout,
               float* __restrict__ delta, Geo g) {
  const int64_t row = int64_t(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= g.B * g.T * g.H) return;
  const T* o = out + row * g.D;
  const T* d = dout + row * g.D;
  float acc = 0.f;
  for (int64_t c = lane; c < g.D; c += 32) acc = fmaf(to_f(o[c]), to_f(d[c]), acc);
  acc = warp_sum(acc);
  if (lane == 0) {
    const int64_t h = row % g.H, bt = row / g.H;
    delta[stat_off(g, bt / g.T, h, bt % g.T)] = acc;
  }
}

// The vector form. kVecTurn 16-byte vectors of each tensor a lane a turn:
// 8 registers a vector pair, 32 for the turn's loads.
constexpr int kVecTurn = 4;

// 16 bytes on the read-only path, evict-first (.cs): each is read once
__device__ __forceinline__ uint4 load_once(const uint4* p) {
  uint4 v;
  asm("ld.global.cs.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// acc + a . b over one vector's elements in order, each widened to f32
__device__ __forceinline__ float dot_vec(float acc, uint4 a, uint4 b, float) {
  acc = fmaf(__uint_as_float(a.x), __uint_as_float(b.x), acc);
  acc = fmaf(__uint_as_float(a.y), __uint_as_float(b.y), acc);
  acc = fmaf(__uint_as_float(a.z), __uint_as_float(b.z), acc);
  return fmaf(__uint_as_float(a.w), __uint_as_float(b.w), acc);
}

// a bf16 pair in a word: the element at the lower address in the low half
__device__ __forceinline__ float dot_pair(float acc, uint32_t a, uint32_t b) {
  acc = fmaf(__uint_as_float(a << 16), __uint_as_float(b << 16), acc);
  return fmaf(__uint_as_float(a & 0xffff0000u), __uint_as_float(b & 0xffff0000u), acc);
}

__device__ __forceinline__ float dot_vec(float acc, uint4 a, uint4 b, __nv_bfloat16) {
  acc = dot_pair(acc, a.x, b.x);
  acc = dot_pair(acc, a.y, b.y);
  acc = dot_pair(acc, a.z, b.z);
  return dot_pair(acc, a.w, b.w);
}

// nvec: 16-byte vectors a row. Every lane reaches the shuffles: a group past
// the last row loads nothing and writes nothing.
template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
attn_bwd_delta_vec(const T* __restrict__ out, const T* __restrict__ dout,
                   float* __restrict__ delta, int rows, int nvec, int T_, int H) {
  const int lane = threadIdx.x & (L - 1);
  const int row = int(blockIdx.x) * (kThreads / L) + int(threadIdx.x) / L;
  const bool live = row < rows;
  const uint4* o4 = reinterpret_cast<const uint4*>(out) + (live ? row : 0) * nvec;
  const uint4* d4 = reinterpret_cast<const uint4*>(dout) + (live ? row : 0) * nvec;
  const int end = live ? nvec : 0;
  float acc = 0.f;
  for (int base = lane; base < end; base += kVecTurn * L) {
    uint4 a[kVecTurn], b[kVecTurn];
#pragma unroll
    for (int k = 0; k < kVecTurn; ++k) {
      if (base + k * L < end) {
        a[k] = load_once(o4 + base + k * L);
        b[k] = load_once(d4 + base + k * L);
      }
    }
#pragma unroll
    for (int k = 0; k < kVecTurn; ++k)
      if (base + k * L < end) acc = dot_vec(acc, a[k], b[k], T());
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (live && lane == 0) {
    const int h = row % H, bt = row / H;
    delta[(bt / T_ * H + h) * T_ + bt % T_] = acc;
  }
}

template <typename T>
int run_delta(const void* out, const void* dout, float* delta, const Geo& g, cudaStream_t st) {
  const int64_t blocks = (g.B * g.T * g.H + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks <= 0) return 0;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  attn_bwd_delta<T><<<dim3(unsigned(blocks)), kThreads, 0, st>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, g);
  return int(cudaGetLastError());
}

template <typename T, int L>
int launch_vec(const void* out, const void* dout, float* delta, const Geo& g, cudaStream_t st) {
  const int64_t rows = g.B * g.T * g.H;
  const int64_t blocks = (rows + kThreads / L - 1) / (kThreads / L);
  attn_bwd_delta_vec<T, L><<<dim3(unsigned(blocks)), kThreads, 0, st>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, int(rows),
      int(g.D * int64_t(sizeof(T)) / 16), int(g.T), int(g.H));
  return int(cudaGetLastError());
}

// The vector form with `lanes` lanes a row, refused (cudaErrorInvalidValue)
// off its alignments or where `lanes` is not the rule's for this D.
template <typename T>
int run_delta_vec(const void* out, const void* dout, float* delta, const Geo& g, int lanes,
                  cudaStream_t st) {
  const int64_t row_bytes = g.D * int64_t(sizeof(T));
  const int64_t nvec = row_bytes / 16;
  int want = 1;
  while (want < 32 && 2 * want <= nvec) want *= 2;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(dout)) & 15u) == 0;
  if (!aligned || row_bytes % 16 != 0 || nvec == 0 || lanes != want ||
      g.B * g.T * g.H * g.D >= (int64_t(1) << 31))
    return int(cudaErrorInvalidValue);
  if (g.B * g.T * g.H == 0) return 0;
  switch (lanes) {
    case 1: return launch_vec<T, 1>(out, dout, delta, g, st);
    case 2: return launch_vec<T, 2>(out, dout, delta, g, st);
    case 4: return launch_vec<T, 4>(out, dout, delta, g, st);
    case 8: return launch_vec<T, 8>(out, dout, delta, g, st);
    case 16: return launch_vec<T, 16>(out, dout, delta, g, st);
    default: return launch_vec<T, 32>(out, dout, delta, g, st);
  }
}

}  // namespace

extern "C" {

// lanes: 0 for the general form, else the vector form with that many lanes
// a row (ops/attention.py delta_form)
int tb_attn_bwd_delta(const void* out, const void* dout, int dtype, float* delta, int64_t B,
                      int64_t T, int64_t H, int64_t D, int lanes, void* stream) {
  const Geo g{B, T, H, D};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lanes != 0)
    return dtype == 0 ? run_delta_vec<float>(out, dout, delta, g, lanes, st)
                      : run_delta_vec<__nv_bfloat16>(out, dout, delta, g, lanes, st);
  return dtype == 0 ? run_delta<float>(out, dout, delta, g, st)
                    : run_delta<__nv_bfloat16>(out, dout, delta, g, st);
}

}  // extern "C"
