// K4, FabricNet's elementwise chain, hand-written for Hopper (sm_90a):
//
//   add_rms_norm_fwd  <- incubator_brpc_tpu/models/fabricnet.py:119 _rms_norm,
//                        with the residual add of _stage_fn (:193-209) whose
//                        sum it reads: s = x + delta, n = s * rsqrt(mean(s^2)
//                        + 1e-6) over each row, and the row's rsqrt (rstd)
//   rms_norm_bwd      <- the gradient JAX's autodiff takes through _rms_norm,
//                        with the residual stream's own gradient g_s added
//                        where the train step adds it
//   gelu_tanh_fwd     <- :123 _gelu (jax.nn.gelu, the tanh form)
//   gelu_tanh_bwd     <- its gradient (jax.vjp's chain)
//
//   moe_combine_fwd   <- _moe's gate and combine (:164 sigmoid(tokens @ gate_w),
//                        :175 ungrouped * g) with _stage_fn's last residual
//                        add (:208): g = 1 / (1 + exp(-logit)), out[r] = s[r]
//                        + yr[r % e, r // e] * g[r], the experts' output read
//                        in its expert layout (e, t / e, d)
//   moe_combine_bwd   <- its gradient: d_yr = dy * g in the expert layout,
//                        d_logit = sum_d(yr * dy) * (g * (1 - g))
//   mse_loss_fwd      <- _local_loss's mean((out - y)^2) (:266-268, :281) and,
//                        in the same pass, its gradient for d(loss) = 1
//   ring_mean_add_fwd <- with heads = 0, _stage_fn's last MLP residual add
//                        and x + _ring_context(x) (:138, :205-207) over the
//                        sp ring: s = x + delta, m = each rank's block mean
//                        folded around the ring / sp, s2 = s + m
//   ring_mean_add_bwd <- its gradient: g_s = g + c, c the transposed ring
//                        over the blocks' sums of g, which reaches both x
//                        and delta
//
// Rows are the last dimension of a row-major tensor, rows * d elements from
// the base pointer; f32 or bf16 (dtype 0 or 1), computed in f32. The
// reference rounds op by op: in bf16 XLA rounds every elementwise op's
// result to bf16, with JAX's weakly typed constants rounded to bf16 too
// (Jax<T> below). Each kernel rounds where its plain version in
// ops/elementwise.py rounds, so each rounds where the reference does:
// - add_rms_norm_fwd: s rounded to the dtype; each square rounded to the
//   dtype and summed in f32; the mean (the sum times 1/d, as PyTorch's mean
//   on the card and XLA form it) rounded to the dtype, + eps rounded, rsqrtf
//   (as torch.rsqrt) rounded; n = s * r rounded. Only the row sum's order
//   differs from the plain version's.
// - rms_norm_bwd: jax.vjp's chain in the train step's form, each op rounded
//   to the dtype: u = g_n k, (g_s + u), then + bb (2 s) with bb = (w / d)
//   rounded, w = sum(s g_n) m kept in f32 (XLA drops the jaxpr's rounding
//   before w's conversion to f32; in bf16 the product is exact), m = -0.5
//   (k / j), k = rstd. It recomputes j = mean(s^2) + eps, the value the
//   reference divides by (not rstd), in its first pass, which reads s for
//   sum(s g_n) anyway, as add_rms_norm_fwd forms the mean: squares rounded
//   to the dtype, summed, times 1/d, rounded, + eps rounded. Storing j from
//   add_rms_norm_fwd would cost a fourth output there for one fewer
//   product an element here.
// - gelu_tanh_fwd: x (0.5 (1 + tanh(beta (x + kappa (x (x x)))))), each op
//   rounded, tanhf's result rounded.
// - gelu_tanh_bwd: jax.vjp(_gelu)'s chain, each op rounded: i = tanh(beta
//   (x + kappa x^3)), p = (0.5 (x dy)) (1 - i), s = beta (p + p i), then
//   (dy (0.5 (1 + i)) + s) + (kappa s) (3 (x x)).
// - moe_combine_fwd: g = 1 / (1 + expf(-x)) (jax.nn.sigmoid as XLA expands
//   it), each op rounded; the product rounded, then the sum rounded.
// - moe_combine_bwd: d_yr = dy * g rounded; d_logit = sum * (g * (1 - g)),
//   each op rounded, the sum that of the products yr * dy rounded to the
//   dtype, rounded to the dtype.
// The row sums of products (sum(s g_n), sum(s^2) in rms_norm_bwd, and
// moe_combine_bwd's) run in f64, rounded to f32 and then to the dtype:
// exact for rows whose terms span fewer than about 2^34 (bf16) or 2^18
// (f32) in magnitude, so this order and the plain version's give the same
// bits. The reference sums them in bf16 in XLA:CPU's window order: a
// difference by design (ROADMAP), as copying that order is.
// - mse_loss_fwd: diff = out - y rounded, its square rounded and summed in
//   f32, the sum divided by n and rounded; d_out = (1/n rounded to the
//   dtype) * (2 diff), rounded. The sum's order differs from the plain
//   version's; every block's partial is added in block order by a second
//   kernel of one block, so a rerun gives the same bits (no atomics).
// - ring_mean_add_fwd: s = x + delta rounded; the column sum over T of x +
//   delta in f32 before that rounding (XLA drops the jaxpr's rounding of s
//   ahead of the mean's conversion to f32, as it drops w's in rms_norm_bwd)
//   in f64, rounded to f32, times 1/T in f32 (XLA multiplies by the
//   reciprocal), rounded to the dtype (jnp.mean's convert); s + m rounded.
//   The sp = 1 ring's 0 + m and m / 1 are exact. With sp > 1 the mean is a
//   rank block's (1/T the block's rows), and rank i folds the ring's means
//   as ring_stream does, ((0 + m_i) + m_{i-1}) + ..., each add rounded to
//   the dtype, then times 1/sp in f32 (XLA's division by a constant),
//   rounded: the column sums, the ring and the add in one launch.
// - ring_mean_add_bwd: the vjp's reduce_sum of g over T runs in the dtype:
//   the f64 sum rounded to f32 and then to the dtype, times 1/T in f32,
//   rounded; g + c rounded. With sp > 1: each block's sum so, times 1/sp
//   rounded, then the transposed ring, v_i + (v_{i+1} + (... + 0)), each
//   add rounded, times 1/T of the block, rounded.
// The intrinsics __fadd_rn / __fmul_rn / __fsub_rn / __fdiv_rn keep nvcc
// from contracting products and sums into FMAs that the plain versions do
// not take, across a rounding or not. The build has no --use_fast_math
// (ops/kernels.py): tanhf and expf are the ones PyTorch's own kernels call.
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
//   f32 (warp shuffles, then the warps' partials through shared memory).
//   add_rms_norm_fwd keeps its pieces of the row in registers through the
//   reduction and writes n from them, so the row is read once, for rows of
//   at most 2,048 pieces (4 a thread at 512 threads): with the row's
//   pointers on one 16-byte phase, 16,384 bf16 or 8,192 f32 elements; with
//   them on different phases every element is a piece of its own, 2,048
//   elements. About two pieces a thread (128 threads for a 2048-wide bf16
//   row) keep two loads in flight each. A longer row takes pass 2, which
//   reads it again, from L2 (a 2048-wide bf16 row is 4 KB). rms_norm_bwd
//   reads its rows twice in this way, and reads rstd rather than
//   recomputing the rsqrt; its row sums take one f64 add an element each.
// - The GeLUs are grid-stride loops over the elements.
// - The ring mean reduces over the sequence, not along a row: a block owns
//   one (batch, 128-byte column tile) and all T rows of it (64 bf16 or 32
//   f32 columns; at the bench width 4 x 32 = 128 blocks of 16 warps, about
//   one wave, each thread with 8 16-byte loads in flight). Pass 1 reads x
//   and delta once, keeps s in shared memory (T x 128 B, 128 KB at T =
//   1024) and sums each column in f64 (across a warp's rows by shuffles,
//   then 16 warps' partials in shared memory); pass 2 adds the mean to s
//   from shared memory and writes s2, on bf16x2 adds, with no conversion.
//   So each element is read once and written once, and no (B, T, d)
//   broadcast of the mean is ever formed. Where T x 128 B does not fit (T
//   past about 1,750), pass 2 reads x and delta again (from L2 or HBM): the
//   forward then moves 5 streams instead of 3, the backward 3 instead of 2. The gradient is the same
//   kernel with one input. 16-byte loads where d is a whole number of
//   vectors and every pointer is 16-byte aligned, else single elements
//   (odd d, ragged column tiles, views off alignment).
//
// Plain C interface, loaded with ctypes by incubator_brpc_tpu_torch/ops/
// kernels.py and wrapped by ops/elementwise.py. Every entry point launches
// on the given stream, allocates nothing, and returns the first CUDA error
// (0 on success).

#include "elementwise.cuh"

namespace {

constexpr int kMaxNormThreads = 512;
constexpr int kEltThreads = 256;
constexpr int64_t kMaxEltBlocks = 132 * 16;  // 16 blocks of 256 threads an SM

// JAX's constants, as it rounds its weakly typed Python floats to T: the
// norm's 1e-6, and jax.nn.gelu's 0.044715 and sqrt(2 / pi)
template <typename T>
struct Jax;
template <>
struct Jax<float> {
  static constexpr float eps = 9.999999974752427e-07f, kappa = 0.044714998453855515f,
                         beta = 0.7978845834732056f;
};
template <>
struct Jax<__nv_bfloat16> {
  static constexpr float eps = 9.98377799987793e-07f, kappa = 0.044677734375f, beta = 0.796875f;
};

// one op of the reference's chain: the f32 result rounded to T
template <typename T>
__device__ __forceinline__ float rmul(float a, float b) { return round_to<T>(__fmul_rn(a, b)); }
template <typename T>
__device__ __forceinline__ float radd(float a, float b) { return round_to<T>(__fadd_rn(a, b)); }
template <typename T>
__device__ __forceinline__ float rsub(float a, float b) { return round_to<T>(__fsub_rn(a, b)); }
template <typename T>
__device__ __forceinline__ float rdiv(float a, float b) { return round_to<T>(__fdiv_rn(a, b)); }

// 1 / d rounded to f32: the reference divides by a constant as a multiply by it
__device__ __forceinline__ float inv(int64_t d) { return __fdiv_rn(1.0f, float(d)); }

// Two elements of T, as the reference's ops take them. f32: a float2, each
// op one f32 op. bf16: their two bf16 values in 32 bits (element 0 in the
// low half), each op one mul/add/sub.rn.bf16x2, correctly rounded, which is
// the f32 op rounded to bf16 (f32's 24 bits are at least twice bf16's 8
// plus 2, so the double rounding is innocuous: Figueroa, 1995), in one
// instruction for two elements where an f32 op and its rounding take two
// (the rounding's conversion at a quarter of the f32 rate) for one. tanh
// runs in f32 on both (tanhf, the result rounded to T).
template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using V = float2;
  static __device__ __forceinline__ V splat(float c) { return make_float2(c, c); }
  static __device__ __forceinline__ V mul(V a, V b) {
    return make_float2(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y));
  }
  static __device__ __forceinline__ V add(V a, V b) {
    return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
  }
  static __device__ __forceinline__ V sub(V a, V b) {
    return make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
  }
  static __device__ __forceinline__ V tanh(V a) { return make_float2(tanhf(a.x), tanhf(a.y)); }
  static __device__ __forceinline__ float lo(V a) { return a.x; }
  static __device__ __forceinline__ float hi(V a) { return a.y; }
  static __device__ __forceinline__ V pack(float l, float h) { return make_float2(l, h); }
};
template <>
struct Pair<__nv_bfloat16> {
  using V = uint32_t;
  static __device__ __forceinline__ V splat(float c) {  // c: a bf16 value
    const uint32_t b = __float_as_uint(c) >> 16;
    return b | b << 16;
  }
  static __device__ __forceinline__ V mul(V a, V b) {
    V d;
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ V add(V a, V b) {
    V d;
    asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ V sub(V a, V b) {
    V d;
    asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ float lo(V a) { return __uint_as_float(a << 16); }
  static __device__ __forceinline__ float hi(V a) { return __uint_as_float(a & 0xFFFF0000u); }
  static __device__ __forceinline__ V pack(float l, float h) {  // rounded to nearest even
    V d;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(h), "f"(l));
    return d;
  }
  static __device__ __forceinline__ V tanh(V a) { return pack(tanhf(lo(a)), tanhf(hi(a))); }
};

// The W elements at p (a 16-byte vector, or W = 1 one element, doubled) as
// (W + 1) / 2 pairs, and back (W = 1: the low one)
template <int W>
__device__ __forceinline__ void load_pairs(const float* p, float2 (&v)[(W + 1) / 2]) {
  if constexpr (W == 1) {
    v[0] = make_float2(*p, *p);
  } else {
    static_assert(W == kVec<float>, "a vector is 16 bytes");
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = make_float2(u.x, u.y);
    v[1] = make_float2(u.z, u.w);
  }
}
template <int W>
__device__ __forceinline__ void load_pairs(const __nv_bfloat16* p, uint32_t (&v)[(W + 1) / 2]) {
  if constexpr (W == 1) {
    const uint32_t b = *reinterpret_cast<const uint16_t*>(p);
    v[0] = b | b << 16;
  } else {
    static_assert(W == kVec<__nv_bfloat16>, "a vector is 16 bytes");
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  }
}
template <int W>
__device__ __forceinline__ void store_pairs(float* p, const float2 (&v)[(W + 1) / 2]) {
  if constexpr (W == 1)
    *p = v[0].x;
  else
    *reinterpret_cast<float4*>(p) = make_float4(v[0].x, v[0].y, v[1].x, v[1].y);
}
template <int W>
__device__ __forceinline__ void store_pairs(__nv_bfloat16* p, const uint32_t (&v)[(W + 1) / 2]) {
  if constexpr (W == 1)
    *reinterpret_cast<uint16_t*>(p) = uint16_t(v[0]);
  else
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
}

// -- K4a: s = x + delta, n = s * rsqrt(mean(s^2) + 1e-6), rstd --------------------
// One block a row. delta and s are both null (s is x) or both set. With HOLD
// > 0, a row of at most HOLD pieces a thread (16-byte vectors, or single
// elements where its pointers disagree or before and after its 16-byte
// boundaries) is read once: each thread keeps its pieces of s in registers
// from pass 1 and writes n from them (launch_add_rms_norm sets HOLD and the
// threads). HOLD = 0, rows past kHold pieces a thread at 512 threads: the
// two-pass path, whose pass 2 reads back the s this thread wrote in pass 1
// (the same pieces), so no pointer is __restrict__.
constexpr int kHold = 4;

// x and delta over [c, c + W) into p and q (q untouched without delta)
template <int W, typename T>
__device__ __forceinline__ void load_piece(const T* xr, const T* dr, int64_t c, float (&p)[W],
                                           float (&q)[W]) {
  load<W>(xr + c, p);
  if (dr != nullptr) load<W>(dr + c, q);
}

// p = s = x + delta rounded to T and stored (p = x without delta); each
// square rounded to T and added to sq in f32
template <int W, typename T>
__device__ __forceinline__ void sum_piece(const T* dr, T* sr, int64_t c, float (&p)[W],
                                          const float (&q)[W], float& sq) {
  if (dr != nullptr) {
#pragma unroll
    for (int i = 0; i < W; ++i) p[i] = round_to<T>(__fadd_rn(p[i], q[i]));
    store<W>(sr + c, p);
  }
#pragma unroll
  for (int i = 0; i < W; ++i) sq = __fadd_rn(sq, round_to<T>(__fmul_rn(p[i], p[i])));
}

// kDelta false: delta is null, and known to be, so no register is kept for it
template <typename T, int HOLD, bool kDelta>
__global__ void add_rms_norm_fwd(const T* x, const T* delta, T* s, T* n, float* rstd,
                                 int64_t d) {
  __shared__ float red[32];
  constexpr int V = kVec<T>;
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  const T* dr = kDelta && delta ? delta + row * d : nullptr;
  T* sr = kDelta && delta ? s + row * d : nullptr;
  T* nr = n + row * d;
  const int64_t head = head_of<T>(d, xr, dr, sr, nr);
  // the row's pieces: `head` single elements, nv vectors, then the tail's singles
  const int64_t nv = (d - head) / V, pieces = d - nv * (V - 1);
  if (HOLD > 0 && pieces <= int64_t(HOLD) * blockDim.x) {
    // piece p = threadIdx.x + j blockDim.x of this thread, a vector at
    // head + (p - head) V or a single element at c(p). Every load is issued
    // before the first store of s: the pointers may alias, so the compiler
    // would not move a load above a store.
    constexpr int H = HOLD > 0 ? HOLD : 1;
    float a[H][V], b[H][V];
    const auto vec = [&](int64_t p) { return p >= head && p < head + nv; };
    const auto single = [&](int64_t p) { return p < head ? p : p + nv * (V - 1); };
#pragma unroll
    for (int j = 0; j < HOLD; ++j) {
      const int64_t p = threadIdx.x + int64_t(j) * blockDim.x;
      if (p < pieces) {
        if (vec(p)) {
          load_piece<V>(xr, dr, head + (p - head) * V, a[j], b[j]);
        } else {
          float one[1], two[1] = {0.f};
          load_piece<1>(xr, dr, single(p), one, two);
          a[j][0] = one[0], b[j][0] = two[0];
        }
      }
    }
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < HOLD; ++j) {
      const int64_t p = threadIdx.x + int64_t(j) * blockDim.x;
      if (p < pieces) {
        if (vec(p)) {
          sum_piece<V>(dr, sr, head + (p - head) * V, a[j], b[j], sq);
        } else {
          float one[1] = {a[j][0]}, two[1] = {b[j][0]};
          sum_piece<1>(dr, sr, single(p), one, two, sq);
          a[j][0] = one[0];
        }
      }
    }
    const float mean = round_to<T>(__fmul_rn(block_sum(sq, red), inv(d)));
    const float r = round_to<T>(rsqrtf(radd<T>(mean, Jax<T>::eps)));
    if (threadIdx.x == 0) rstd[row] = r;
#pragma unroll
    for (int j = 0; j < HOLD; ++j) {
      const int64_t p = threadIdx.x + int64_t(j) * blockDim.x;
      if (p < pieces) {
        if (vec(p)) {
#pragma unroll
          for (int i = 0; i < V; ++i) a[j][i] = __fmul_rn(a[j][i], r);
          store<V>(nr + head + (p - head) * V, a[j]);
        } else {
          float one[1] = {__fmul_rn(a[j][0], r)};
          store<1>(nr + single(p), one);
        }
      }
    }
    return;
  }
  float sq = 0.f;
  walk<T>(d, head, threadIdx.x, blockDim.x, [&](auto w, int64_t c) {
    constexpr int W = decltype(w)::value;
    float a[W], b[W];
    load_piece<W>(xr, dr, c, a, b);
    sum_piece<W>(dr, sr, c, a, b, sq);
  });
  const float mean = round_to<T>(__fmul_rn(block_sum(sq, red), inv(d)));
  const float r = round_to<T>(rsqrtf(radd<T>(mean, Jax<T>::eps)));
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

// -- K4b: g = (g_s + g_n k) + bb (2 s), bb = (sum(s g_n) m) / d, m = -0.5 k / j --------
// One block a row; g_s may be null.
template <typename T>
__global__ void rms_norm_bwd(const T* __restrict__ s, const float* __restrict__ rstd,
                             const T* __restrict__ gn, const T* __restrict__ gs,
                             T* __restrict__ g, int64_t d) {
  __shared__ double red[2][32];
  const int64_t row = blockIdx.x;
  const T* sr = s + row * d;
  const T* nr = gn + row * d;
  const T* gsr = gs ? gs + row * d : nullptr;
  T* gr = g + row * d;
  const int64_t head = head_of<T>(d, sr, nr, gsr, gr);
  using P = Pair<T>;
  double sq = 0.0, dot = 0.0;
  walk<T>(d, head, threadIdx.x, blockDim.x, [&](auto w, int64_t c) {
    constexpr int W = decltype(w)::value;
    typename P::V a[(W + 1) / 2], b[(W + 1) / 2];
    load_pairs<W>(sr + c, a);
    load_pairs<W>(nr + c, b);
#pragma unroll
    for (int i = 0; i < (W + 1) / 2; ++i) {
      const auto q = P::mul(a[i], a[i]), r = P::mul(a[i], b[i]);
      sq += double(P::lo(q));
      dot += double(P::lo(r));
      if (W > 1) {  // a single element is doubled: its high half is a copy
        sq += double(P::hi(q));
        dot += double(P::hi(r));
      }
    }
  });
  const float k = rstd[row];
  const float j = radd<T>(round_to<T>(__fmul_rn(__double2float_rn(block_sum(sq, red[0])), inv(d))),
                          Jax<T>::eps);
  const float m = rmul<T>(-0.5f, rdiv<T>(k, j));
  const float wm = __fmul_rn(round_to<T>(__double2float_rn(block_sum(dot, red[1]))), m);
  const float bb = round_to<T>(__fmul_rn(wm, inv(d)));
  const auto k2 = P::splat(k), bb2 = P::splat(bb), two = P::splat(2.0f);
  walk<T>(d, head, threadIdx.x, blockDim.x, [&](auto w, int64_t c) {
    constexpr int W = decltype(w)::value;
    typename P::V a[(W + 1) / 2], b[(W + 1) / 2], r[(W + 1) / 2];
    load_pairs<W>(sr + c, a);
    load_pairs<W>(nr + c, b);
#pragma unroll
    for (int i = 0; i < (W + 1) / 2; ++i) b[i] = P::mul(b[i], k2);
    if (gsr != nullptr) {
      load_pairs<W>(gsr + c, r);
#pragma unroll
      for (int i = 0; i < (W + 1) / 2; ++i) b[i] = P::add(r[i], b[i]);
    }
#pragma unroll
    for (int i = 0; i < (W + 1) / 2; ++i) b[i] = P::add(b[i], P::mul(bb2, P::mul(two, a[i])));
    store_pairs<W>(gr + c, b);
  });
}

// -- K4c / K4d: the tanh GeLU and its gradient -------------------------------------

// beta (x + kappa (x (x x))), each op rounded to T
template <typename T>
__device__ __forceinline__ typename Pair<T>::V gelu_inner(typename Pair<T>::V x) {
  using P = Pair<T>;
  return P::mul(P::splat(Jax<T>::beta),
                P::add(x, P::mul(P::splat(Jax<T>::kappa), P::mul(x, P::mul(x, x)))));
}

template <typename T>
__device__ __forceinline__ typename Pair<T>::V gelu_f(typename Pair<T>::V x) {
  using P = Pair<T>;
  const auto t = P::tanh(gelu_inner<T>(x));
  return P::mul(x, P::mul(P::splat(0.5f), P::add(P::splat(1.0f), t)));
}

template <typename T>
__device__ __forceinline__ typename Pair<T>::V gelu_bwd_f(typename Pair<T>::V dy,
                                                          typename Pair<T>::V x) {
  using P = Pair<T>;
  const auto half = P::splat(0.5f), one = P::splat(1.0f);
  const auto i = P::tanh(gelu_inner<T>(x));
  const auto p = P::mul(P::mul(half, P::mul(x, dy)), P::sub(one, i));
  const auto s = P::mul(P::splat(Jax<T>::beta), P::add(p, P::mul(p, i)));
  const auto t = P::add(P::mul(dy, P::mul(half, P::add(one, i))), s);
  return P::add(t, P::mul(P::mul(P::splat(Jax<T>::kappa), s),
                          P::mul(P::splat(3.0f), P::mul(x, x))));
}

template <typename T>
__global__ void gelu_tanh_fwd(const T* __restrict__ x, T* __restrict__ y, int64_t n) {
  const int64_t head = head_of<T>(n, x, y, nullptr, nullptr);
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  walk<T>(n, head, t, int64_t(gridDim.x) * blockDim.x, [&](auto w, int64_t c) {
    constexpr int W = decltype(w)::value;
    typename Pair<T>::V a[(W + 1) / 2];
    load_pairs<W>(x + c, a);
#pragma unroll
    for (int i = 0; i < (W + 1) / 2; ++i) a[i] = gelu_f<T>(a[i]);
    store_pairs<W>(y + c, a);
  });
}

template <typename T>
__global__ void gelu_tanh_bwd(const T* __restrict__ x, const T* __restrict__ dy,
                              T* __restrict__ dx, int64_t n) {
  const int64_t head = head_of<T>(n, x, dy, dx, nullptr);
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  walk<T>(n, head, t, int64_t(gridDim.x) * blockDim.x, [&](auto w, int64_t c) {
    constexpr int W = decltype(w)::value;
    typename Pair<T>::V a[(W + 1) / 2], b[(W + 1) / 2];
    load_pairs<W>(x + c, a);
    load_pairs<W>(dy + c, b);
#pragma unroll
    for (int i = 0; i < (W + 1) / 2; ++i) a[i] = gelu_bwd_f<T>(b[i], a[i]);
    store_pairs<W>(dx + c, a);
  });
}

// -- K4e-b / K4e-c: the MoE's gate and combine with the residual add ----------------
// One block a row r of t; the experts' rows are yr[(r % e) * per + r / e].

template <typename T>
__global__ void moe_combine_fwd(const T* s, const T* yr, const T* logit, T* out, T* gate,
                                int64_t d, int64_t e, int64_t per) {
  const int64_t r = blockIdx.x;
  const float g = rdiv<T>(1.0f, radd<T>(1.0f, round_to<T>(expf(-to_f(logit[r])))));
  if (threadIdx.x == 0) gate[r] = from_f<T>(g);
  const T* sr = s + r * d;
  const T* yrow = yr + ((r % e) * per + r / e) * d;
  T* orow = out + r * d;
  const int64_t head = head_of<T>(d, sr, yrow, orow, nullptr);
  walk<T>(d, head, threadIdx.x, blockDim.x, [&](auto w, int64_t c) {
    constexpr int W = decltype(w)::value;
    float a[W], b[W];
    load<W>(sr + c, a);
    load<W>(yrow + c, b);
#pragma unroll
    for (int i = 0; i < W; ++i) a[i] = __fadd_rn(a[i], round_to<T>(__fmul_rn(b[i], g)));
    store<W>(orow + c, a);
  });
}

template <typename T>
__global__ void moe_combine_bwd(const T* __restrict__ dy, const T* __restrict__ yr,
                                const T* __restrict__ gate, T* __restrict__ dyr,
                                T* __restrict__ dlogit, int64_t d, int64_t e, int64_t per) {
  __shared__ double red[32];
  const int64_t r = blockIdx.x;
  const float g = to_f(gate[r]);
  const T* dr = dy + r * d;
  const int64_t er = ((r % e) * per + r / e) * d;
  const T* yrow = yr + er;
  T* drow = dyr + er;
  const int64_t head = head_of<T>(d, dr, yrow, drow, nullptr);
  double dot = 0.0;
  walk<T>(d, head, threadIdx.x, blockDim.x, [&](auto w, int64_t c) {
    constexpr int W = decltype(w)::value;
    float a[W], b[W];
    load<W>(dr + c, a);
    load<W>(yrow + c, b);
#pragma unroll
    for (int i = 0; i < W; ++i) {
      dot += double(rmul<T>(b[i], a[i]));
      a[i] = __fmul_rn(a[i], g);
    }
    store<W>(drow + c, a);
  });
  const float dg = round_to<T>(__double2float_rn(block_sum(dot, red)));
  if (threadIdx.x == 0) dlogit[r] = from_f<T>(__fmul_rn(dg, rmul<T>(g, rsub<T>(1.0f, g))));
}

// -- K4e-d: the loss and its gradient ---------------------------------------------------
// Grid-stride over the n elements; block b writes its partial sum of squares
// to partial[b]; mse_loss_sum (one block) adds the partials in block order.

template <typename T>
__global__ void mse_loss_fwd(const T* __restrict__ out, const T* __restrict__ y,
                             T* __restrict__ dout, float* __restrict__ partial, int64_t n,
                             float gsq) {
  __shared__ float red[32];
  const int64_t head = head_of<T>(n, out, y, dout, nullptr);
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  float sq = 0.f;
  walk<T>(n, head, t, int64_t(gridDim.x) * blockDim.x, [&](auto w, int64_t c) {
    constexpr int W = decltype(w)::value;
    float a[W], b[W];
    load<W>(out + c, a);
    load<W>(y + c, b);
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const float diff = round_to<T>(__fsub_rn(a[i], b[i]));
      sq = __fadd_rn(sq, round_to<T>(__fmul_rn(diff, diff)));
      a[i] = __fmul_rn(gsq, __fmul_rn(2.0f, diff));
    }
    store<W>(dout + c, a);
  });
  const float total = block_sum(sq, red);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

template <typename T>
__global__ void mse_loss_sum(const float* __restrict__ partial, int blocks, T* __restrict__ loss,
                             int64_t n) {
  __shared__ float red[32];
  float v = 0.f;
  for (int b = threadIdx.x; b < blocks; b += blockDim.x) v = __fadd_rn(v, partial[b]);
  v = block_sum(v, red);
  if (threadIdx.x == 0) *loss = from_f<T>(__fdiv_rn(v, float(n)));
}

// -- K4f: s2 = s + mean_T(s), s = x + delta; its gradient g + bcast(c) --------------
// x, delta, out: (B, t, d) row-major; blockIdx.x = b tiles + tile. The t rows
// are the blocks of sp ranks of the sp ring, tl = t / sp rows each, in rank
// order. Thread (r0, lc) takes rows r0 + R j of a rank's block, columns
// [lc, lc + W) of the block's tile, as (W + 1) / 2 pairs: W = kVec<T>
// (16-byte pieces) or 1 (one element, doubled). kGrad: x is g, delta null.
// kResident: s stays in shared memory between the passes; else pass 2 reads
// x and delta again.
constexpr int kRingThreads = 512;
constexpr int kRingTileBytes = 128;
constexpr int kRingUnroll = 4;  // rows a thread loads before it uses them
constexpr size_t kRingSmemMax = 232448;  // 227 KB, a block's most

template <typename T, int W>
struct RingShape {
  static constexpr int C = kRingTileBytes / int(sizeof(T));  // columns a tile
  static constexpr int kTpr = C / W;                          // threads a row
  static constexpr int R = kRingThreads / kTpr;               // rows a pass
  static constexpr int kRW = kTpr < 32 ? 32 / kTpr : 1;       // rows a warp holds
  // red (the warps' partial sums, R / kRW x C f64), each rank's block value
  // and its mean (2 sp x C f32), then the resident tile
  static size_t head(int64_t sp) {
    return size_t(R / kRW) * C * 8 + 2 * size_t(sp) * C * 4;
  }
  static size_t smem(int64_t t, int64_t sp, bool resident) {
    return head(sp) + (resident ? size_t(t) * kRingTileBytes : 0);
  }
};

template <typename T, int W, bool kResident, bool kGrad>
__global__ void __launch_bounds__(kRingThreads)
ring_mean_add(const T* __restrict__ x, const T* __restrict__ delta, T* __restrict__ out,
              int64_t t, int64_t d, int64_t tiles, int64_t sp) {
  using S = RingShape<T, W>;
  using P = Pair<T>;
  using V = typename P::V;
  constexpr int C = S::C, R = S::R, U = kRingUnroll, NP = (W + 1) / 2;
  constexpr int kGroups = R / S::kRW;  // the warps' partial sums of a column
  extern __shared__ __align__(16) unsigned char smem_ring[];
  double* red = reinterpret_cast<double*>(smem_ring);           // [kGroups][C]
  float* local = reinterpret_cast<float*>(red + kGroups * C);   // [sp][C]
  float* mean = local + sp * C;                                 // [sp][C]
  T* tile = reinterpret_cast<T*>(mean + sp * C);                // [t][C]
  const int lc = int(threadIdx.x) % S::kTpr * W, r0 = int(threadIdx.x) / S::kTpr;
  const int64_t b = blockIdx.x / tiles, col = blockIdx.x % tiles * C + lc;
  const bool live = col < d;  // W divides d on the vector path
  const int64_t base = b * t * d + col, tl = t / sp;

  // x and delta at rows r .. r + (U - 1) R (below end) of this thread's
  // columns, every load issued first
  const auto load_rows = [&](int64_t r, int64_t end, V (&a)[U][NP], V (&q)[U][NP]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t ru = r + int64_t(u) * R;
      if (ru < end) {
        load_pairs<W>(x + base + ru * d, a[u]);
        if (delta != nullptr) load_pairs<W>(delta + base + ru * d, q[u]);
      }
    }
  };

  // pass 1, a rank's block at a time: the block's column sums of x + delta
  // in f32 before its rounding to T (XLA:CPU drops the jaxpr's rounding of s
  // ahead of the mean's conversion to f32), and s = x + delta rounded to T
  // (one bf16x2 add a pair) into the tile; the sums across the rows a warp
  // holds (lanes kTpr apart), then across the warps, in warp order, into the
  // block's value: its mean (forward) or its sum rounded to T (gradient)
  for (int64_t j = 0; j < sp; ++j) {
    const int64_t end = (j + 1) * tl;
    double acc[W];
#pragma unroll
    for (int i = 0; i < W; ++i) acc[i] = 0.0;
    if (live) {
      for (int64_t r = j * tl + r0; r < end; r += int64_t(U) * R) {
        V a[U][NP], q[U][NP];
        load_rows(r, end, a, q);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int64_t ru = r + int64_t(u) * R;
          if (ru < end) {
#pragma unroll
            for (int i = 0; i < NP; ++i) {
              float lo = P::lo(a[u][i]), hi = P::hi(a[u][i]);
              if (delta != nullptr) {
                lo = __fadd_rn(lo, P::lo(q[u][i]));
                hi = __fadd_rn(hi, P::hi(q[u][i]));
                a[u][i] = P::add(a[u][i], q[u][i]);
              }
              acc[2 * i] += double(lo);
              if (W > 1) acc[2 * i + 1] += double(hi);  // W = 1: hi is a copy
            }
            if (kResident) store_pairs<W>(tile + ru * C + lc, a[u]);
          }
        }
      }
    }
#pragma unroll
    for (int o = S::kTpr; o < 32; o <<= 1)
#pragma unroll
      for (int i = 0; i < W; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
    if (int(threadIdx.x) % 32 < S::kTpr) {
#pragma unroll
      for (int i = 0; i < W; ++i) red[r0 / S::kRW * C + lc + i] = acc[i];
    }
    __syncthreads();
    if (threadIdx.x < C) {
      double sum = 0.0;
      for (int rr = 0; rr < kGroups; ++rr) sum += red[rr * C + threadIdx.x];
      const float m = __double2float_rn(sum);
      local[j * C + threadIdx.x] = kGrad ? round_to<T>(m) : round_to<T>(__fmul_rn(m, inv(tl)));
    }
    __syncthreads();
  }
  // the sp ring (_ring_context), a column a thread, every rank in its own
  // order, each add rounded to T. Forward: rank i folds ((0 + m_i) +
  // m_{i-1}) + ..., then times 1/sp. Gradient: the block sums times 1/sp,
  // then rank i takes the transposed ring v_i + (v_{i+1} + (... + 0)), then
  // times 1/tl. With sp = 1 no ring: the mean, or the sum times 1/t.
  if (threadIdx.x < C) {
    const int c = int(threadIdx.x);
    if (sp == 1) {
      mean[c] = kGrad ? round_to<T>(__fmul_rn(local[c], inv(t))) : local[c];
    } else {
      if (kGrad) {
        for (int64_t j = 0; j < sp; ++j)
          local[j * C + c] = round_to<T>(__fmul_rn(local[j * C + c], inv(sp)));
      }
      for (int64_t i = 0; i < sp; ++i) {
        float acc = 0.0f;
        for (int64_t k = 0; k < sp; ++k) {
          const int64_t src = kGrad ? (i + sp - 1 - k) % sp : (i - k + sp) % sp;
          acc = round_to<T>(__fadd_rn(local[src * C + c], acc));
        }
        mean[i * C + c] = round_to<T>(__fmul_rn(acc, kGrad ? inv(tl) : inv(sp)));
      }
    }
  }
  __syncthreads();
  if (!live) return;
  // pass 2: s2 = s + m of the row's rank, one bf16x2 add a pair, from the
  // tile (or x and delta again) to out
  for (int64_t j = 0; j < sp; ++j) {
    const int64_t end = (j + 1) * tl;
    const float* mj = mean + j * C;
    V mv[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) mv[i] = P::pack(mj[lc + 2 * i], mj[lc + (W > 1 ? 2 * i + 1 : 0)]);
    for (int64_t r = j * tl + r0; r < end; r += int64_t(U) * R) {
      V a[U][NP], q[U][NP];
      if (kResident) {
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (r + int64_t(u) * R < end) load_pairs<W>(tile + (r + int64_t(u) * R) * C + lc, a[u]);
      } else {
        load_rows(r, end, a, q);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r + int64_t(u) * R < end) {
#pragma unroll
          for (int i = 0; i < NP; ++i) {
            if (!kResident && delta != nullptr) a[u][i] = P::add(a[u][i], q[u][i]);
            a[u][i] = P::add(a[u][i], mv[i]);
          }
          store_pairs<W>(out + base + (r + int64_t(u) * R) * d, a[u]);
        }
      }
    }
  }
}

template <typename T, bool kGrad>
cudaError_t launch_ring_mean_add(const void* x, const void* delta, void* out, int64_t batch,
                                 int64_t t, int64_t d, int64_t sp, cudaStream_t st) {
  constexpr int V = kVec<T>;
  const bool vec = d % V == 0 && phase(x) == 0 && phase(out) == 0 &&
                   (delta == nullptr || phase(delta) == 0);
  const auto go = [&](auto w) -> cudaError_t {
    constexpr int W = decltype(w)::value;
    using S = RingShape<T, W>;
    const int64_t tiles = (d + S::C - 1) / S::C;
    const bool resident = S::smem(t, sp, true) <= kRingSmemMax;
    const size_t smem = S::smem(t, sp, resident);
    if (smem > kRingSmemMax) return cudaErrorInvalidValue;  // sp too large for the means
    const auto kern = resident ? ring_mean_add<T, W, true, kGrad> : ring_mean_add<T, W, false, kGrad>;
    if (smem > 48 * 1024) {
      const cudaError_t e =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
      if (e != cudaSuccess) return e;
    }
    kern<<<unsigned(batch * tiles), kRingThreads, smem, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(delta), static_cast<T*>(out), t, d, tiles,
        sp);
    return cudaGetLastError();
  };
  return vec ? go(Width<V>()) : go(Width<1>());
}

// -- launches -----------------------------------------------------------------------

// threads for one row of d: a 16-byte piece each, in whole warps, 32 to 512
template <typename T>
unsigned norm_threads(int64_t d) {
  const int64_t pieces = (d + kVec<T> - 1) / kVec<T>;
  const int64_t t = (pieces + 31) / 32 * 32;
  return unsigned(t < 32 ? 32 : t > kMaxNormThreads ? kMaxNormThreads : t);
}

// The most pieces a row of width d at these pointers has: rows whose
// pointers disagree are all single elements; rows on one phase have at most
// V - 1 single elements before their first 16-byte boundary and as many
// after their last, and exactly the first row's count when every row starts
// on the first row's phase.
template <typename T>
int64_t norm_pieces(const void* x, const void* delta, const void* s, const void* n, int64_t d) {
  constexpr int64_t V = kVec<T>;
  const int ph = phase(x);
  if (phase(n) != ph || (delta != nullptr && (phase(delta) != ph || phase(s) != ph))) return d;
  const int64_t worst = d * int64_t(sizeof(T)) % 16 == 0
                            ? d - (d - head_of<T>(d, x, delta, s, n)) / V * (V - 1)
                            : d / V + 2 * (V - 1);
  return worst < d ? worst : d;
}

// add_rms_norm_fwd's launch: rows of at most kHold x kMaxNormThreads pieces
// are read once, with about two pieces a thread (two loads in flight each)
// and HOLD the fewest of 1, 2, 4 that hold them;
// longer rows take two passes, one piece a thread a pass.
template <typename T>
cudaError_t launch_add_rms_norm(const void* x, const void* delta, void* s, void* n, float* rstd,
                                int64_t rows, int64_t d, cudaStream_t st) {
  const int64_t pieces = norm_pieces<T>(x, delta, s, n, d);
  int hold = 0;
  unsigned threads = norm_threads<T>(d);
  if (pieces <= int64_t(kHold) * kMaxNormThreads) {
    const int64_t t = ((pieces + 1) / 2 + 31) / 32 * 32;
    threads = unsigned(t < 32 ? 32 : t > kMaxNormThreads ? kMaxNormThreads : t);
    hold = pieces <= threads ? 1 : pieces <= 2 * int64_t(threads) ? 2 : 4;
  }
  const auto kern = [&](auto h) {
    const auto k = delta != nullptr ? add_rms_norm_fwd<T, decltype(h)::value, true>
                                    : add_rms_norm_fwd<T, decltype(h)::value, false>;
    k<<<unsigned(rows), threads, 0, st>>>(static_cast<const T*>(x), static_cast<const T*>(delta),
                                          static_cast<T*>(s), static_cast<T*>(n), rstd, d);
  };
  switch (hold) {
    case 1: kern(Width<1>()); break;
    case 2: kern(Width<2>()); break;
    case 4: kern(Width<4>()); break;
    default: kern(Width<0>());
  }
  return cudaGetLastError();
}

unsigned elt_blocks(int64_t n, int vec) {
  const int64_t blocks = (n / vec + kEltThreads) / kEltThreads;
  return unsigned(blocks < kMaxEltBlocks ? blocks : kMaxEltBlocks);
}

constexpr int kSumThreads = 1024;

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
  return int(dtype == 0 ? launch_add_rms_norm<float>(x, delta, s, n, rstd, rows, d, st)
                        : launch_add_rms_norm<__nv_bfloat16>(x, delta, s, n, rstd, rows, d, st));
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

// s, out: [t, d]; yr: [e, t / e, d]; logit, gate: [t]
int tb_moe_combine_fwd(const void* s, const void* yr, const void* logit, void* out, void* gate,
                       int64_t t, int64_t d, int64_t e, int dtype, void* stream) {
  if (!rows_ok(t, d, dtype) || e <= 0 || t % e) return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    moe_combine_fwd<float><<<unsigned(t), norm_threads<float>(d), 0, st>>>(
        static_cast<const float*>(s), static_cast<const float*>(yr),
        static_cast<const float*>(logit), static_cast<float*>(out), static_cast<float*>(gate), d,
        e, t / e);
  else
    moe_combine_fwd<__nv_bfloat16><<<unsigned(t), norm_threads<__nv_bfloat16>(d), 0, st>>>(
        static_cast<const __nv_bfloat16*>(s), static_cast<const __nv_bfloat16*>(yr),
        static_cast<const __nv_bfloat16*>(logit), static_cast<__nv_bfloat16*>(out),
        static_cast<__nv_bfloat16*>(gate), d, e, t / e);
  return int(cudaGetLastError());
}

// dy: [t, d]; yr, dyr: [e, t / e, d]; gate, dlogit: [t]
int tb_moe_combine_bwd(const void* dy, const void* yr, const void* gate, void* dyr, void* dlogit,
                       int64_t t, int64_t d, int64_t e, int dtype, void* stream) {
  if (!rows_ok(t, d, dtype) || e <= 0 || t % e) return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    moe_combine_bwd<float><<<unsigned(t), norm_threads<float>(d), 0, st>>>(
        static_cast<const float*>(dy), static_cast<const float*>(yr),
        static_cast<const float*>(gate), static_cast<float*>(dyr), static_cast<float*>(dlogit), d,
        e, t / e);
  else
    moe_combine_bwd<__nv_bfloat16><<<unsigned(t), norm_threads<__nv_bfloat16>(d), 0, st>>>(
        static_cast<const __nv_bfloat16*>(dy), static_cast<const __nv_bfloat16*>(yr),
        static_cast<const __nv_bfloat16*>(gate), static_cast<__nv_bfloat16*>(dyr),
        static_cast<__nv_bfloat16*>(dlogit), d, e, t / e);
  return int(cudaGetLastError());
}

// The number of partial sums tb_mse_loss_fwd writes for n elements (its grid).
int64_t tb_mse_loss_blocks(int64_t n, int dtype) {
  return int64_t(elt_blocks(n, dtype == 0 ? kVec<float> : kVec<__nv_bfloat16>));
}

// The second of tb_mse_loss_fwd's two kernels alone: loss = the sum of the
// blocks' partial sums, in block order, over n, rounded to the dtype.
int tb_mse_loss_sum(const float* partial, int64_t blocks, void* loss, int64_t n, int dtype,
                    void* stream) {
  if (blocks <= 0 || blocks > 0x7fffffffLL || n <= 0 || (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    mse_loss_sum<float><<<1, kSumThreads, 0, st>>>(partial, int(blocks),
                                                   static_cast<float*>(loss), n);
  else
    mse_loss_sum<__nv_bfloat16><<<1, kSumThreads, 0, st>>>(
        partial, int(blocks), static_cast<__nv_bfloat16*>(loss), n);
  return int(cudaGetLastError());
}

// out, y, dout: n elements; partial: tb_mse_loss_blocks(n) floats; loss: one element.
// gsq: 1/n rounded to the dtype (the gradient reaching each square). Two
// launches: the pass over the elements, then tb_mse_loss_sum.
int tb_mse_loss_fwd(const void* out, const void* y, void* dout, float* partial, void* loss,
                    int64_t n, float gsq, int dtype, void* stream) {
  if (n <= 0 || (dtype != 0 && dtype != 1)) return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = unsigned(tb_mse_loss_blocks(n, dtype));
  if (dtype == 0) {
    mse_loss_fwd<float><<<blocks, kEltThreads, 0, st>>>(
        static_cast<const float*>(out), static_cast<const float*>(y), static_cast<float*>(dout),
        partial, n, gsq);
  } else {
    mse_loss_fwd<__nv_bfloat16><<<blocks, kEltThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(y),
        static_cast<__nv_bfloat16*>(dout), partial, n, gsq);
  }
  const int rc = int(cudaGetLastError());
  return rc ? rc : tb_mse_loss_sum(partial, int64_t(blocks), loss, n, dtype, stream);
}

// x, delta, out: [batch, t, d]; delta may be null. out = s + the sp ring's mean
// of s, s = x + delta, the t rows sp ranks' blocks (sp = 1: mean_t(s)).
int tb_ring_mean_add_fwd(const void* x, const void* delta, void* out, int64_t batch, int64_t t,
                         int64_t d, int64_t sp, int dtype, void* stream) {
  if (batch <= 0 || t <= 0 || sp <= 0 || t % sp || !rows_ok(batch * ((d + 31) / 32), d, dtype))
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(dtype == 0 ? launch_ring_mean_add<float, false>(x, delta, out, batch, t, d, sp, st)
                        : launch_ring_mean_add<__nv_bfloat16, false>(x, delta, out, batch, t, d,
                                                                     sp, st));
}

// g, out: [batch, t, d]. out = g + c, c the transposed sp ring over the blocks'
// sums of g (sp = 1: the sum of g over t, rounded to the dtype, over t).
int tb_ring_mean_add_bwd(const void* g, void* out, int64_t batch, int64_t t, int64_t d,
                         int64_t sp, int dtype, void* stream) {
  if (batch <= 0 || t <= 0 || sp <= 0 || t % sp || !rows_ok(batch * ((d + 31) / 32), d, dtype))
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(dtype == 0 ? launch_ring_mean_add<float, true>(g, nullptr, out, batch, t, d, sp, st)
                        : launch_ring_mean_add<__nv_bfloat16, true>(g, nullptr, out, batch, t, d,
                                                                    sp, st));
}

}  // extern "C"
