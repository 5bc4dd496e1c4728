// K2 of the quantized collective sessions, hand-written for Hopper (sm_90a):
//
//   quantize_rows      <- incubator_brpc_tpu/parallel/quantized.py:197 _jq_quantize
//                         (run by :235 _make_quantized_pmean_kernel on the own row,
//                         and by parallel/mc_dispatch.py:827 _make_ck_quant on a
//                         checkpointed state)
//   dequant_mean_rows  <- parallel/quantized.py:220 _jq_dequantize + :256-258
//                         (every gathered party dequantized, summed over the
//                         parties, divided by their count)
//
// The contract is bitwise: the host restores a quantized checkpoint with the
// numpy twin (quantized.py np_quantize / np_dequantize), and a resumed chain
// re-quantizes that state, so kernel and twin must agree in every bit.
// Per block of `block` floats of a row:
//
//   y = amax / qmax                  (IEEE division, rounded to nearest)
//   e = clip(ceil(log2 y), -126, 127), with e = 0 for y = 0 (np.frexp's
//       exponent, minus 1 when the mantissa is exactly 0.5)
//   q = clip(rint(x / 2^e), -qmax, qmax)          (qmax 127 int8, 7 int4)
//
// int4 stores (q + 8) in nibbles, the even element in the low nibble. The
// dequantize-mean writes, for every element i and every party row r,
//   out[r, i] = (sum over p = 0, 1, ..., P-1 of q[p, i] * 2^e[p, i / block]) / P
// with the sum taken in party order, as the plain version and the numpy
// twin take it.
//
// Hazards, and what the code does about each:
// - No --use_fast_math, -ftz=true or -prec-div=false (ops/kernels.py builds
//   without them), and every rounding operation is an explicit _rn intrinsic
//   besides: __fdiv_rn for amax / qmax, x / 2^e and the mean (a division by
//   a non-power of two rounds once), __fmul_rn and __fadd_rn for q * 2^e and
//   the party sum, so nvcc can neither contract them into an FMA (which
//   would keep an overflowing product finite) nor flush a subnormal.
// - 2^e is built from its exponent bits (subnormal bit patterns below
//   -126), never with exp2f, whose error is not zero.
// - The exponent comes from the bits of y, not frexpf: zero gives e = 0 (the
//   scale is 1 and q = 0), a subnormal y gives at most -126 before the clamp,
//   a normal y = 2^k (mantissa bits zero; frexp's 0.5) gives k.
// - rintf rounds half to even (roundf would round half away from zero); the
//   clip to +-qmax comes before the cast to an integer.
//
// What bounds them on the card: bytes. Per float, quantize does an
// absolute value, a max, a division and a rint, far below the card's
// operations per byte; its traffic is 4 bytes in and 1 (int4: 1/2) out.
// Dequantize-mean reads P (int4: P/2) bytes and writes 4 P bytes per
// element: the state it writes is the whole [P, width] f32 row set. The
// design is the simple one: quantize puts one warp on one scale block
// (lane l holds elements l, l + 32, ...; the amax comes from a
// __shfl_xor_sync max, exact in any order; int4 pairs lanes l and l + 1
// with one shuffle and the even lane writes the byte), so a 32-float block
// is one coalesced 128-byte load per warp; it takes a row stride, so a
// chunk of the session state, cut at a multiple of the block, is quantized
// where it lies. Dequantize-mean puts one thread on one element: it walks
// the parties in order, then stores the mean into every party's row, and
// the stores of neighbouring threads are neighbouring words.
//
// Plain C interface, loaded with ctypes by incubator_brpc_tpu_torch/ops/
// kernels.py and wrapped by ops/quantize.py. Every entry point launches on
// the given stream, allocates nothing, and returns the first CUDA error
// (0 on success).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEMin = -126;
constexpr int kEMax = 127;

// clip(ceil(log2 y), -126, 127) for a finite y >= 0, and 0 for y == 0.
__device__ __forceinline__ int block_exponent(float y) {
  const uint32_t bits = __float_as_uint(y);
  const int biased = int((bits >> 23) & 0xffu);
  const uint32_t mant = bits & 0x7fffffu;
  if (biased == 0) return mant == 0u ? 0 : kEMin;  // zero; subnormal: ceil(log2 y) <= -126
  const int e = biased - 127 + (mant != 0u ? 1 : 0);
  return e > kEMax ? kEMax : e;  // a normal y has e >= -126 already
}

// 2^e, exactly, for any int8 e (below -126 as a subnormal).
__device__ __forceinline__ float exp2_exact(int e) {
  return e >= kEMin ? __uint_as_float(uint32_t(e + 127) << 23)
                    : __uint_as_float(1u << (e + 149));
}

// One warp per (row, scale block). x: [rows, nfloats] f32 at row stride
// x_stride (floats); q: [rows, nfloats] int8 or [rows, nfloats / 2] packed
// int4, contiguous; e: [rows, nblocks] int8, contiguous.
template <bool kInt4>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, int64_t x_stride, int64_t rows, int64_t nfloats,
                int block, float qmax, uint8_t* __restrict__ q, int8_t* __restrict__ e_out) {
  const int lane = threadIdx.x & 31;
  const int64_t nblocks = nfloats / block;
  const int64_t gwarp = int64_t(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (gwarp >= rows * nblocks) return;  // the same for every lane of the warp
  const int64_t row = gwarp / nblocks;
  const int64_t b = gwarp - row * nblocks;
  const float* xb = x + row * x_stride + b * block;

  float amax = 0.0f;
  for (int i = lane; i < block; i += 32) amax = fmaxf(amax, fabsf(__ldg(xb + i)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const int e = block_exponent(__fdiv_rn(amax, qmax));
  const float scale = exp2_exact(e);
  if (lane == 0) e_out[row * nblocks + b] = int8_t(e);

  const int64_t first = row * nfloats + b * block;  // element index of the block's start
  for (int base = 0; base < block; base += 32) {  // uniform across the warp
    const int i = base + lane;
    int v = 0;
    if (i < block) {
      const float r = rintf(__fdiv_rn(__ldg(xb + i), scale));
      v = int(fminf(fmaxf(r, -qmax), qmax));
    }
    if (kInt4) {
      const int odd = __shfl_down_sync(0xffffffffu, v, 1);  // element i + 1 (block is even)
      if (i < block && (lane & 1) == 0)
        q[(first + i) >> 1] = uint8_t(((v + 8) & 0xf) | (((odd + 8) & 0xf) << 4));
    } else if (i < block) {
      q[first + i] = uint8_t(int8_t(v));
    }
  }
}

__device__ __forceinline__ float dequant_one(const uint8_t* __restrict__ q,
                                             const int8_t* __restrict__ e, int64_t p,
                                             int64_t nfloats, int64_t nblocks, int block,
                                             int64_t i, bool int4) {
  int v;
  if (int4) {
    const uint8_t byte = __ldg(q + p * (nfloats >> 1) + (i >> 1));
    v = int((i & 1) ? (byte >> 4) : (byte & 0xf)) - 8;
  } else {
    v = int(int8_t(__ldg(q + p * nfloats + i)));
  }
  return __fmul_rn(float(v), exp2_exact(int(__ldg(e + p * nblocks + i / block))));
}

// One thread per element i. kMean: every row of out gets the party-ordered
// mean; else row p gets party p's own dequantized values.
template <bool kInt4, bool kMean>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const uint8_t* __restrict__ q, const int8_t* __restrict__ e, int64_t parties,
               int64_t nfloats, int block, float* __restrict__ out) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= nfloats) return;
  const int64_t nblocks = nfloats / block;
  if (kMean) {
    float acc = dequant_one(q, e, 0, nfloats, nblocks, block, i, kInt4);
    for (int64_t p = 1; p < parties; ++p)
      acc = __fadd_rn(acc, dequant_one(q, e, p, nfloats, nblocks, block, i, kInt4));
    const float m = __fdiv_rn(acc, float(parties));
    for (int64_t r = 0; r < parties; ++r) out[r * nfloats + i] = m;
  } else {
    for (int64_t p = 0; p < parties; ++p)
      out[p * nfloats + i] = dequant_one(q, e, p, nfloats, nblocks, block, i, kInt4);
  }
}

inline unsigned blocks_for(int64_t n, int64_t per_block) {
  return unsigned((n + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

// x [rows, nfloats] f32 (row stride x_stride floats) -> q, e (see above).
int tb_quantize_rows(const float* x, int64_t x_stride, int64_t rows, int64_t nfloats, int block,
                     int int4, uint8_t* q, int8_t* e, cudaStream_t stream) {
  const int64_t warps = rows * (nfloats / block);
  if (warps == 0) return 0;
  const float qmax = int4 ? 7.0f : 127.0f;
  if (int4)
    quantize_kernel<true><<<blocks_for(warps, kWarps), kThreads, 0, stream>>>(
        x, x_stride, rows, nfloats, block, qmax, q, e);
  else
    quantize_kernel<false><<<blocks_for(warps, kWarps), kThreads, 0, stream>>>(
        x, x_stride, rows, nfloats, block, qmax, q, e);
  return int(cudaGetLastError());
}

// q, e of `parties` rows (contiguous) -> out [parties, nfloats] f32.
int tb_dequant_mean_rows(const uint8_t* q, const int8_t* e, int64_t parties, int64_t nfloats,
                         int block, int int4, int mean, float* out, cudaStream_t stream) {
  if (parties == 0 || nfloats == 0) return 0;
  const unsigned grid = blocks_for(nfloats, kThreads);
  if (int4 && mean)
    dequant_kernel<true, true><<<grid, kThreads, 0, stream>>>(q, e, parties, nfloats, block, out);
  else if (int4)
    dequant_kernel<true, false><<<grid, kThreads, 0, stream>>>(q, e, parties, nfloats, block, out);
  else if (mean)
    dequant_kernel<false, true><<<grid, kThreads, 0, stream>>>(q, e, parties, nfloats, block, out);
  else
    dequant_kernel<false, false><<<grid, kThreads, 0, stream>>>(q, e, parties, nfloats, block, out);
  return int(cudaGetLastError());
}

}  // extern "C"
