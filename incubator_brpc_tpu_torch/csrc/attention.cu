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
// element read). One warp a row.
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

template <typename T>
int run_delta(const void* out, const void* dout, float* delta, const Geo& g, cudaStream_t st) {
  const int64_t blocks = (g.B * g.T * g.H + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks <= 0) return 0;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  attn_bwd_delta<T><<<dim3(unsigned(blocks)), kThreads, 0, st>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, g);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int tb_attn_bwd_delta(const void* out, const void* dout, int dtype, float* delta, int64_t B,
                      int64_t T, int64_t H, int64_t D, void* stream) {
  const Geo g{B, T, H, D};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? run_delta<float>(out, dout, delta, g, st)
                    : run_delta<__nv_bfloat16>(out, dout, delta, g, st);
}

}  // extern "C"
