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
//   besides: __fdiv_rn for amax / qmax and the mean (a division by a non-power
//   of two rounds once), __fmul_rn for x * 2^-e and q * 2^e, __fadd_rn for
//   the party sum, so nvcc can neither contract them into an FMA (which
//   would keep an overflowing product finite) nor flush a subnormal.
// - 2^e and 2^-e are built from their exponent bits (subnormal bit patterns
//   below -126), never with exp2f, whose error is not zero.
// - x / 2^e is computed as x * 2^-e. For every e in [-126, 127], 2^-e is an
//   f32 (at e = 127 the subnormal 2^-127), so both name the same real number
//   and an IEEE operation rounds it once, with gradual underflow; the same
//   holds for +-0, +-inf and NaN (tests/test_torch_quantized.py pins it for
//   every exponent). The general form keeps the division.
// - The exponent comes from the bits of y, not frexpf: zero gives e = 0 (the
//   scale is 1 and q = 0), a subnormal y gives at most -126 before the clamp,
//   a normal y = 2^k (mantissa bits zero; frexp's 0.5) gives k.
// - rintf rounds half to even (roundf would round half away from zero); the
//   clip to +-qmax comes before the cast to an integer.
// - The block's amax is a max, exact in any order; it starts from 0 and takes
//   fmaxf, which drops a NaN, in both forms alike.
// - The party sum starts from -0.0f, the identity of IEEE addition, so it
//   equals the sum started from party 0's value, also where that is -0.
//
// What bounds them on the card: bytes. Per float, quantize does an
// absolute value, a max, a multiply and a rint, far below the card's
// operations per byte; its traffic is 4 bytes in and 1 (int4: 1/2) out.
// Dequantize-mean reads P (int4: P/2) bytes and writes 4 P bytes per
// element: the state it writes is the whole [P, width] f32 row set.
//
// Each kernel has two forms; the wrapper (ops/quantize.py quantize_form,
// dequant_form) picks one by shape before the launch, and both count as the
// same kernel.
// - The vector form of quantize: a group of block / 4 lanes (a power of two,
//   1 to 32) owns one scale block, each lane one 16-byte float4 of it, so a
//   warp covers 512 contiguous bytes and every element is loaded once, into
//   registers. A thread takes kUnroll such warp tiles at a stride of the
//   grid's warps and issues all their loads before the first max (2 tiles
//   ran faster on the H100 than 1, 4 or 8). The group's max takes
//   log2(block / 4) __shfl_xor_sync steps; each lane scales by 2^-e, packs its four values
//   into one 32-bit (int8) or 16-bit (int4, even element in the low nibble)
//   store, and the group's first lane writes the exponent byte. Rows lie on
//   grid.y, so a chunk of the session state (a view at a row stride, cut at
//   a multiple of the block) is quantized where it lies. It takes blocks of
//   4 to 128 floats, rows on 16-byte boundaries and at most 65535 rows.
// - The general form of quantize takes every block that supports() admits
//   (6, 10, ...) and any row start: one warp a block (lane l holds elements
//   l, l + 32, ...; the amax from a __shfl_xor_sync max; int4 pairs lanes l
//   and l + 1 with one shuffle and the even lane writes the byte).
// - The vector form of dequantize-mean: a thread owns 4 consecutive elements,
//   all in one block; per party one 32-bit (int4: 16-bit) load of q and one
//   exponent byte, the loads of 4 parties issued ahead of their adds, the
//   adds in party order element by element, then one float4 store into each
//   of the P rows, evict-first (st.global.cs). mean = 0 stores each party's
//   own values into its row instead. It takes blocks of a multiple of 4 and a
//   q on a 4-byte (int4: 2-byte) boundary. 8 int4 elements a thread (one
//   32-bit word) halved the threads and ran slower on the H100; so did
//   plain stores at 64 parties, a deeper party unroll and several units a
//   thread (PERF.md).
// - The general form of dequantize-mean: one thread an element, one byte of
//   q and of e a party, P scalar stores.
//
// Plain C interface, loaded with ctypes by incubator_brpc_tpu_torch/ops/
// kernels.py and wrapped by ops/quantize.py. Every entry point launches on
// the given stream, allocates nothing, and returns the first CUDA error
// (0 on success); a form the arguments do not fit is refused with
// cudaErrorInvalidValue, never run.

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDequantThreads = 128;  // the vector dequantize: fewer, fuller blocks
constexpr int kUnroll = 2;            // warp tiles a thread of the vector quantize takes
constexpr int kPartyUnroll = 4;       // parties whose loads the vector dequantize issues ahead
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

// 2^e, exactly, for any e in [-149, 127] (below -126 as a subnormal).
__device__ __forceinline__ float exp2_exact(int e) {
  return e >= kEMin ? __uint_as_float(uint32_t(e + 127) << 23)
                    : __uint_as_float(1u << (e + 149));
}

__device__ __forceinline__ int quant_one(float x, float inv, float qmax) {
  const float r = rintf(__fmul_rn(x, inv));  // x / 2^e, rounded once
  return int(fminf(fmaxf(r, -qmax), qmax));
}

// Four quantized values packed as they lie in q: int8 bytes in a 32-bit
// word, or int4 nibbles (q + 8) in a 16-bit one, the first element lowest.
template <bool kInt4>
__device__ __forceinline__ uint32_t pack4(float4 v, float inv, float qmax) {
  const int a = quant_one(v.x, inv, qmax), b = quant_one(v.y, inv, qmax);
  const int c = quant_one(v.z, inv, qmax), d = quant_one(v.w, inv, qmax);
  if (kInt4)
    return uint32_t((a + 8) & 0xf) | uint32_t((b + 8) & 0xf) << 4 |
           uint32_t((c + 8) & 0xf) << 8 | uint32_t((d + 8) & 0xf) << 12;
  return uint32_t(uint8_t(a)) | uint32_t(uint8_t(b)) << 8 | uint32_t(uint8_t(c)) << 16 |
         uint32_t(uint8_t(d)) << 24;
}

// The vector form: row blockIdx.y of x [rows, nfloats] f32 at row stride
// x_stride (floats, a multiple of 4); a block is kG float4s. q [rows,
// nfloats] int8 or [rows, nfloats / 2] packed int4 and e [rows, nfloats /
// (4 kG)] int8, contiguous.
template <bool kInt4, int kG>
__global__ void __launch_bounds__(kThreads)
quantize_vec_kernel(const float* __restrict__ x, int64_t x_stride, int64_t nfloats, float qmax,
                    uint8_t* __restrict__ q, int8_t* __restrict__ e_out) {
  static_assert(kG >= 1 && kG <= 32 && (kG & (kG - 1)) == 0, "1-32 lanes, a power of two");
  const int lane = threadIdx.x & 31;
  const int64_t row = blockIdx.y;
  const int64_t f4 = nfloats >> 2;  // float4s a row
  const int64_t warp = int64_t(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int64_t wstride = int64_t(gridDim.x) * kWarps;
  const float4* __restrict__ xr = reinterpret_cast<const float4*>(x + row * x_stride);

  float4 v[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {  // every load issued before the first max
    const int64_t c = (warp + k * wstride) * 32 + lane;
    v[k] = c < f4 ? __ldg(xr + c) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int64_t base = (warp + k * wstride) * 32;
    if (base >= f4) break;  // the same for every lane, and later tiles lie further on
    const int64_t c = base + lane;
    float amax = fmaxf(fmaxf(fabsf(v[k].x), fabsf(v[k].y)), fmaxf(fabsf(v[k].z), fabsf(v[k].w)));
    amax = fmaxf(amax, 0.0f);  // as the general form's max from 0: four NaNs give 0
#pragma unroll
    for (int off = kG / 2; off > 0; off >>= 1)  // within the group: xor stays inside it
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (c < f4) {  // a group lies wholly inside or outside the row: f4 % kG == 0
      const int e = block_exponent(__fdiv_rn(amax, qmax));
      const uint32_t packed = pack4<kInt4>(v[k], exp2_exact(-e), qmax);
      const int64_t slot = row * f4 + c;  // this lane's 4 values: 4 bytes (int4: 2) into q
      if (kInt4)
        reinterpret_cast<uint16_t*>(q)[slot] = uint16_t(packed);
      else
        reinterpret_cast<uint32_t*>(q)[slot] = packed;
      if ((lane & (kG - 1)) == 0) e_out[slot / kG] = int8_t(e);  // row * nblocks + c / kG
    }
  }
}

// The general form: one warp per (row, scale block). x: [rows, nfloats] f32
// at row stride x_stride (floats); q: [rows, nfloats] int8 or [rows,
// nfloats / 2] packed int4, contiguous; e: [rows, nblocks] int8, contiguous.
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

// The vector form: thread u owns elements [4 u, 4 u + 4) of every row, one
// 32-bit (int8) or 16-bit (int4) word of q a party, and stores one float4 a
// row with st.global.cs (evict first: the P rows it writes pass through the
// L2 without pushing out the q still to be read). kMean: every row of out
// gets the party-ordered mean; else row p gets party p's own dequantized
// values.
template <bool kInt4, bool kMean>
__global__ void __launch_bounds__(kDequantThreads)
dequant_vec_kernel(const uint8_t* __restrict__ q, const int8_t* __restrict__ e, int64_t parties,
                   int64_t nfloats, int block, float* __restrict__ out) {
  using Word = typename std::conditional<kInt4, uint16_t, uint32_t>::type;  // 4 values of q
  const int64_t units = nfloats / 4;  // also q's words a row, and out's float4s
  const int64_t u = int64_t(blockIdx.x) * kDequantThreads + threadIdx.x;
  if (u >= units) return;
  const Word* __restrict__ qw = reinterpret_cast<const Word*>(q);
  const int64_t nblocks = nfloats / block;
  const int64_t b = u * 4 / block;  // the unit lies in one block: block % 4 == 0
  float4* __restrict__ o4 = reinterpret_cast<float4*>(out);

  float acc[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) acc[k] = -0.0f;
  for (int64_t p0 = 0; p0 < parties; p0 += kPartyUnroll) {
    uint32_t w[kPartyUnroll];
    int ex[kPartyUnroll];
#pragma unroll
    for (int j = 0; j < kPartyUnroll; ++j) {  // the loads of kPartyUnroll parties first
      const int64_t p = p0 + j < parties ? p0 + j : p0;
      w[j] = __ldg(qw + p * units + u);  // widened to 32 bits
      ex[j] = __ldg(e + p * nblocks + b);
    }
#pragma unroll
    for (int j = 0; j < kPartyUnroll; ++j) {
      if (p0 + j >= parties) break;
      const float scale = exp2_exact(ex[j]);
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int qv = kInt4 ? int((w[j] >> (4 * k)) & 0xfu) - 8 : int(int8_t(w[j] >> (8 * k)));
        v[k] = __fmul_rn(float(qv), scale);
      }
      if (kMean) {
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] = __fadd_rn(acc[k], v[k]);  // party order
      } else {
        __stcs(o4 + (p0 + j) * units + u, make_float4(v[0], v[1], v[2], v[3]));
      }
    }
  }
  if (kMean) {
    const float np = float(parties);
    const float4 m = make_float4(__fdiv_rn(acc[0], np), __fdiv_rn(acc[1], np),
                                 __fdiv_rn(acc[2], np), __fdiv_rn(acc[3], np));
    for (int64_t r = 0; r < parties; ++r) __stcs(o4 + r * units + u, m);
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

// The general form: one thread per element i. kMean: every row of out gets
// the party-ordered mean; else row p gets party p's own dequantized values.
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

inline bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <bool kInt4, int kG>
void launch_quantize_vec(const float* x, int64_t x_stride, int64_t rows, int64_t nfloats,
                         float qmax, uint8_t* q, int8_t* e, cudaStream_t stream) {
  const int64_t tiles = ((nfloats >> 2) + 31) / 32;  // warp tiles of 32 float4s a row
  const dim3 grid(blocks_for(tiles, int64_t(kUnroll) * kWarps), unsigned(rows));
  quantize_vec_kernel<kInt4, kG><<<grid, kThreads, 0, stream>>>(x, x_stride, nfloats, qmax, q, e);
}

// The vector form at a block of 4, 8, ..., 128 floats (1 to 32 lanes); false,
// launching nothing, at any other block.
template <bool kInt4>
bool quantize_vec(const float* x, int64_t x_stride, int64_t rows, int64_t nfloats, int block,
                  float qmax, uint8_t* q, int8_t* e, cudaStream_t s) {
  switch (block) {
    case 4: launch_quantize_vec<kInt4, 1>(x, x_stride, rows, nfloats, qmax, q, e, s); break;
    case 8: launch_quantize_vec<kInt4, 2>(x, x_stride, rows, nfloats, qmax, q, e, s); break;
    case 16: launch_quantize_vec<kInt4, 4>(x, x_stride, rows, nfloats, qmax, q, e, s); break;
    case 32: launch_quantize_vec<kInt4, 8>(x, x_stride, rows, nfloats, qmax, q, e, s); break;
    case 64: launch_quantize_vec<kInt4, 16>(x, x_stride, rows, nfloats, qmax, q, e, s); break;
    case 128: launch_quantize_vec<kInt4, 32>(x, x_stride, rows, nfloats, qmax, q, e, s); break;
    default: return false;
  }
  return true;
}

template <bool kVec, bool kInt4, bool kMean>
void launch_dequant(const uint8_t* q, const int8_t* e, int64_t parties, int64_t nfloats, int block,
                    float* out, cudaStream_t stream) {
  if (kVec) {
    dequant_vec_kernel<kInt4, kMean><<<blocks_for(nfloats / 4, kDequantThreads), kDequantThreads, 0,
                                       stream>>>(q, e, parties, nfloats, block, out);
  } else {
    dequant_kernel<kInt4, kMean><<<blocks_for(nfloats, kThreads), kThreads, 0, stream>>>(
        q, e, parties, nfloats, block, out);
  }
}

template <bool kVec>
void dequant(const uint8_t* q, const int8_t* e, int64_t parties, int64_t nfloats, int block,
             int int4, int mean, float* out, cudaStream_t stream) {
  if (int4 && mean)
    launch_dequant<kVec, true, true>(q, e, parties, nfloats, block, out, stream);
  else if (int4)
    launch_dequant<kVec, true, false>(q, e, parties, nfloats, block, out, stream);
  else if (mean)
    launch_dequant<kVec, false, true>(q, e, parties, nfloats, block, out, stream);
  else
    launch_dequant<kVec, false, false>(q, e, parties, nfloats, block, out, stream);
}

}  // namespace

extern "C" {

// x [rows, nfloats] f32 (row stride x_stride floats) -> q, e (see above).
// vector: the vector form, which wants block in {4, 8, ..., 128}, x on a
// 16-byte boundary, x_stride % 4 == 0 (or one row), rows <= 65535 and q on
// a 4-byte boundary.
int tb_quantize_rows(const float* x, int64_t x_stride, int64_t rows, int64_t nfloats, int block,
                     int int4, int vector, uint8_t* q, int8_t* e, cudaStream_t stream) {
  if (rows == 0 || nfloats == 0) return 0;
  const float qmax = int4 ? 7.0f : 127.0f;
  if (vector) {
    if (!aligned(x, 16) || (rows > 1 && x_stride % 4 != 0) || rows > 65535 || !aligned(q, 4))
      return int(cudaErrorInvalidValue);
    const bool known =
        int4 ? quantize_vec<true>(x, x_stride, rows, nfloats, block, qmax, q, e, stream)
             : quantize_vec<false>(x, x_stride, rows, nfloats, block, qmax, q, e, stream);
    if (!known) return int(cudaErrorInvalidValue);
    return int(cudaGetLastError());
  }
  const int64_t warps = rows * (nfloats / block);
  if (int4)
    quantize_kernel<true><<<blocks_for(warps, kWarps), kThreads, 0, stream>>>(
        x, x_stride, rows, nfloats, block, qmax, q, e);
  else
    quantize_kernel<false><<<blocks_for(warps, kWarps), kThreads, 0, stream>>>(
        x, x_stride, rows, nfloats, block, qmax, q, e);
  return int(cudaGetLastError());
}

// q, e of `parties` rows (contiguous) -> out [parties, nfloats] f32.
// vector: the vector form, which wants block % 4 == 0, q on a 4-byte
// (int4: 2-byte) boundary and out on a 16-byte one.
int tb_dequant_mean_rows(const uint8_t* q, const int8_t* e, int64_t parties, int64_t nfloats,
                         int block, int int4, int mean, int vector, float* out,
                         cudaStream_t stream) {
  if (parties == 0 || nfloats == 0) return 0;
  if (vector) {
    if (block % 4 != 0 || !aligned(q, int4 ? 2 : 4) || !aligned(out, 16))
      return int(cudaErrorInvalidValue);
    dequant<true>(q, e, parties, nfloats, block, int4, mean, out, stream);
  } else {
    dequant<false>(q, e, parties, nfloats, block, int4, mean, out, stream);
  }
  return int(cudaGetLastError());
}

}  // extern "C"
