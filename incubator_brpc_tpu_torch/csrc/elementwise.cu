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
//   moe_combine_fwd   <- _moe's gate and combine (:164 sigmoid(tokens @ gate_w),
//                        :175 ungrouped * g) with _stage_fn's last residual
//                        add (:208): g = sigmoid(logit), out[r] = s[r] +
//                        yr[r % e, r // e] * g[r], the experts' output read
//                        in its expert layout (e, t / e, d)
//   moe_combine_bwd   <- its gradient: d_yr = dy * g in the expert layout,
//                        d_logit = sum_d(dy * yr) * (1 - g) * g
//   mse_loss_fwd      <- _local_loss's mean((out - y)^2) (:266-268, :281) and,
//                        in the same pass, its gradient for d(loss) = 1
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
// - moe_combine_fwd: g rounded to the dtype (1 / (1 + expf(-x)), PyTorch's
//   sigmoid); the product rounded, then the sum rounded.
// - moe_combine_bwd: d_yr = dy * g rounded; each dy * yr rounded to the
//   dtype and summed in f32, the sum rounded, then (sum * (1 - g)) * g
//   rounded (PyTorch's sigmoid_backward), as autograd does through the
//   plain version; the row sum's order differs from PyTorch's.
// - mse_loss_fwd: diff = out - y rounded, its square rounded and summed in
//   f32, the sum divided by n and rounded; d_out = (1/n rounded to the
//   dtype) * (2 diff), rounded. The sum's order differs from the plain
//   version's; every block's partial is added in block order by a second
//   kernel of one block, so a rerun gives the same bits (no atomics).
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

#include "elementwise.cuh"

namespace {

constexpr int kMaxNormThreads = 512;
constexpr int kEltThreads = 256;
constexpr int64_t kMaxEltBlocks = 132 * 16;  // 16 blocks of 256 threads an SM
// PyTorch's constants: M_SQRT2 * M_2_SQRTPI * 0.5 rounded once to f32, and 0.044715
constexpr float kBeta = float(1.41421356237309504880 * 1.12837916709551257390 * 0.5);
constexpr float kKappa = float(0.044715);

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

// -- K4e-b / K4e-c: the MoE's gate and combine with the residual add ----------------
// One block a row r of t; the experts' rows are yr[(r % e) * per + r / e].

template <typename T>
__global__ void moe_combine_fwd(const T* s, const T* yr, const T* logit, T* out, T* gate,
                                int64_t d, int64_t e, int64_t per) {
  const int64_t r = blockIdx.x;
  const float g = round_to<T>(__fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-to_f(logit[r])))));
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
  __shared__ float red[32];
  const int64_t r = blockIdx.x;
  const float g = to_f(gate[r]);
  const T* dr = dy + r * d;
  const int64_t er = ((r % e) * per + r / e) * d;
  const T* yrow = yr + er;
  T* drow = dyr + er;
  const int64_t head = head_of<T>(d, dr, yrow, drow, nullptr);
  float dot = 0.f;
  walk<T>(d, head, threadIdx.x, blockDim.x, [&](auto w, int64_t c) {
    constexpr int W = decltype(w)::value;
    float a[W], b[W];
    load<W>(dr + c, a);
    load<W>(yrow + c, b);
#pragma unroll
    for (int i = 0; i < W; ++i) {
      dot = __fadd_rn(dot, round_to<T>(__fmul_rn(a[i], b[i])));
      a[i] = __fmul_rn(a[i], g);
    }
    store<W>(drow + c, a);
  });
  const float dg = round_to<T>(block_sum(dot, red));
  if (threadIdx.x == 0) dlogit[r] = from_f<T>(__fmul_rn(__fmul_rn(dg, __fsub_rn(1.0f, g)), g));
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

}  // extern "C"
