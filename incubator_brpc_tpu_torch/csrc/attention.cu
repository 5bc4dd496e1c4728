// K3's backward on the ring-attention path, hand-written for Hopper (sm_90a):
//
//   attn_bwd_delta  \  the gradient JAX's autodiff takes through ring_attention
//   attn_bwd_dq     /  (lax.scan over block_merge), by recomputation; dQ for
//                      f32 operands, bf16 operands take attn_bwd_dq_tc
//                      (attention_bwd_tc.cu, tensor cores). dK/dV is
//                      attn_bwd_dkdv_tc for bf16 operands and
//                      attn_bwd_dkdv_tf32 (attention_bwd_tf32.cu, 3xTF32 on
//                      the tensor cores) for f32 ones.
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
// widened to f32 and every product, exp and sum is an f32 FMA or op on the
// CUDA cores (no rounding of P to bf16, no tensor cores); the scale is a
// division by sqrtf(Dscale), the head dimension before the zero columns that
// the wrappers add to a D % 4 != 0 (every kernel of K3 takes the padded D
// and the true one); the causal mask is an additive -1e30 from global
// positions, and the running max starts at -1e30, so alpha = exp(m - m_new)
// is 0 (not NaN) on the first fold. Keys past a ragged block end do not
// exist and weigh 0. A key tile that lies wholly in a row tile's future is
// skipped: for every row the first tile folded (hop 0, the diagonal block,
// key 0) holds a visible key, so such a tile would add exp(-1e30 - m) = 0.
//
// What bounds attn_bwd_dq on the card: operations. At the bench shape (B 4,
// T 1024, H 2, D 1024) it does hundreds of f32 FMAs per byte it must move.
// The design keeps the D = 1024 head dimension out of the way of the
// register file: a block holds a 16-row query tile of Q and dO in shared
// memory as f32 (128 KB, so the dynamic shared memory limit is raised),
// streams K and V through 32-wide D chunks for the products that reduce
// over D (scores, dO.V^T), the next chunk's loads in flight in registers
// while the current one is used, and keeps the product that runs along D
// (dS.K) in registers, each thread owning D/256 contiguous columns of every
// row of the tile, read and written as one vector, the next row's loads in
// flight during the current row's FMAs. Shared-memory reads are broadcasts
// or float4 where the operand allows. Nothing carries across blocks, so no
// atomics: a block owns a query tile and walks every hop's key tiles,
// summing over hops in order.
//
// Plain C interface, loaded with ctypes by incubator_brpc_tpu_torch/ops/
// kernels.py. Every entry point launches on the given stream, allocates
// nothing, and returns the first CUDA error (0 on success), or
// cudaErrorInvalidValue for a head dimension it does not take (D % 4 != 0
// or D > 1024).

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDC = 32;          // D chunk staged for the products over D
constexpr int kLd = kDC + 1;     // padded row of a staged chunk: no bank conflicts
constexpr float kNegInf = -1e30f;
constexpr int kMaxD = 1024;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Geo {
  int64_t B, T, H, D, sp, tl;  // tl = T / sp rows per rank
  int64_t Dscale;              // the scores divide by sqrtf(Dscale): D before zero columns
};

// element offset of row (b, t, h) of a (B, T, H, D) tensor
__device__ __forceinline__ int64_t row_off(const Geo& g, int64_t b, int64_t t, int64_t h) {
  return ((b * g.T + t) * g.H + h) * g.D;
}
// offset of (b, h, t) of a (B, H, T) statistic
__device__ __forceinline__ int64_t stat_off(const Geo& g, int64_t b, int64_t h, int64_t t) {
  return (b * g.H + h) * g.T + t;
}

// Columns [c, c + CPT) of a row widened to f32, and back, each one vector
// access: c is a multiple of CPT and CPT divides D, so it is aligned.
template <int CPT>
__device__ __forceinline__ void load_cols(const float* p, float (&x)[CPT]) {
  if constexpr (CPT == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else if constexpr (CPT == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x, x[1] = t.y;
  } else {
    x[0] = *p;
  }
}
template <int CPT>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p, float (&x)[CPT]) {
  if constexpr (CPT == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
    x[0] = __low2float(lo), x[1] = __high2float(lo), x[2] = __low2float(hi), x[3] = __high2float(hi);
  } else if constexpr (CPT == 2) {
    const __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(p);
    x[0] = __low2float(t), x[1] = __high2float(t);
  } else {
    x[0] = __bfloat162float(*p);
  }
}
template <int CPT>
__device__ __forceinline__ void store_cols(float* p, const float (&x)[CPT]) {
  if constexpr (CPT == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (CPT == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}
template <int CPT>
__device__ __forceinline__ void store_cols(__nv_bfloat16* p, const float (&x)[CPT]) {
  if constexpr (CPT == 4) {
    uint2 t;
    *reinterpret_cast<__nv_bfloat162*>(&t.x) = __floats2bfloat162_rn(x[0], x[1]);
    *reinterpret_cast<__nv_bfloat162*>(&t.y) = __floats2bfloat162_rn(x[2], x[3]);
    *reinterpret_cast<uint2*>(p) = t;
  } else if constexpr (CPT == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x[0], x[1]);
  } else {
    *p = __float2bfloat16_rn(x[0]);
  }
}

__host__ __device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// rows [r0, r0 + n) of (b, ., h) of x into dst[n][D] as f32; rows past
// `valid` are zero
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* x, const Geo& g, int64_t b,
                                          int64_t h, int64_t t0, int n, int valid) {
  const int D = int(g.D);
  for (int e = threadIdx.x; e < n * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    dst[e] = r < valid ? to_f(x[row_off(g, b, t0 + r, h) + d]) : 0.f;
  }
}

// A [N][kDC] chunk, rows [t0, t0 + N) x columns [d0, d0 + kDC) of x, staged
// through registers: thread t holds rows t / 32 + 8 it of column t % 32, so
// a warp reads 32 consecutive elements of one row and the row offset is
// computed once. load() issues the global reads (rows past `valid` and
// columns past D are zero) and may stay in flight while the previous chunk
// is used; store() writes them to dst[N][kLd].
template <typename T, int N>
struct Chunk {
  static constexpr int kRows = kThreads / kDC;  // rows per pass
  static constexpr int kPer = N / kRows;
  float v[kPer];
  __device__ __forceinline__ void load(const T* x, const Geo& g, int64_t b, int64_t h,
                                       int64_t t0, int valid, int d0) {
    const int dd = threadIdx.x % kDC, r0 = threadIdx.x / kDC;
    const bool col = d0 + dd < g.D;
    const T* p = x + row_off(g, b, t0 + r0, h) + d0 + dd;
    const int64_t step = kRows * g.H * g.D;
#pragma unroll
    for (int it = 0; it < kPer; ++it)
      v[it] = (col && r0 + it * kRows < valid) ? to_f(p[it * step]) : 0.f;
  }
  __device__ __forceinline__ void store(float* dst) const {
    const int dd = threadIdx.x % kDC, r0 = threadIdx.x / kDC;
#pragma unroll
    for (int it = 0; it < kPer; ++it) dst[(r0 + it * kRows) * kLd + dd] = v[it];
  }
};

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

// ---------------------------------------------------------------------------
// dQ. Block = (b, h, rank i, 16-row query tile); it walks the key tiles of
// every hop's block src = (i - r) mod sp that its rows can see and sums
// dQ += dS . K / sqrt(D) into registers.
// ---------------------------------------------------------------------------

namespace dq {
constexpr int BM = 16, BN = 64;
size_t smem_bytes(int64_t D) {
  return sizeof(float) * (2 * BM * D + 2 * BN * kLd + BN * BM + 2 * BM);
}
}  // namespace dq

template <typename T, int CPT>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dqo, Geo g, int causal) {
  using namespace dq;
  extern __shared__ float4 smem4[];
  const int D = int(g.D);
  float* Qs = reinterpret_cast<float*>(smem4);  // [BM][D]
  float* Os = Qs + BM * D;                      // [BM][D] (dO)
  float* Kc = Os + BM * D;                      // [BN][kLd]
  float* Vc = Kc + BN * kLd;                    // [BN][kLd]
  float* Dt = Vc + BN * kLd;                    // [BN][BM], dS transposed
  float* lse_s = Dt + BN * BM;                  // [BM]
  float* del_s = lse_s + BM;                    // [BM]

  const int tid = threadIdx.x;
  const int64_t tiles = (g.tl + BM - 1) / BM;
  const int64_t bh = blockIdx.x % (g.B * g.H);
  const int64_t h = bh % g.H, b = bh / g.H;
  // the latest row tiles (the most visible keys under the mask) start first
  const int64_t pos = tiles * g.sp - 1 - blockIdx.x / (g.B * g.H);
  const int64_t i = pos / tiles, qt = pos % tiles;
  const int c0 = tid * CPT;  // this thread's columns [c0, c0 + CPT) of every row
  const bool cols = c0 < D;
  const int64_t q0 = i * g.tl + qt * BM;
  const int nq = int(imin(BM, g.tl - qt * BM));

  load_rows(Qs, q, g, b, h, q0, BM, nq);
  load_rows(Os, dout, g, b, h, q0, BM, nq);
  if (tid < BM) {
    lse_s[tid] = tid < nq ? lse[stat_off(g, b, h, q0 + tid)] : 0.f;
    del_s[tid] = tid < nq ? delta[stat_off(g, b, h, q0 + tid)] : 0.f;
  }
  float dqa[BM][CPT];
#pragma unroll
  for (int rq = 0; rq < BM; ++rq)
#pragma unroll
    for (int u = 0; u < CPT; ++u) dqa[rq][u] = 0.f;
  __syncthreads();

  const float sqd = sqrtf(float(g.Dscale));
  const int j = tid & (BN - 1), grp = tid >> 6;  // scores (4 grp + rr, j)
  for (int64_t hop = 0; hop < g.sp; ++hop) {
    const int64_t kbase = ((i - hop) % g.sp + g.sp) % g.sp * g.tl;
    int64_t nkt = (g.tl + BN - 1) / BN;
    if (causal) {
      const int64_t last = q0 + nq - 1 - kbase;
      nkt = last < 0 ? 0 : imin(nkt, last / BN + 1);
    }
    for (int64_t kt = 0; kt < nkt; ++kt) {
      const int64_t k0 = kbase + kt * BN;
      const int nk = int(imin(BN, g.tl - kt * BN));
      float sa[4] = {0.f, 0.f, 0.f, 0.f}, pa[4] = {0.f, 0.f, 0.f, 0.f};
      Chunk<T, BN> kc, vc;
      kc.load(k, g, b, h, k0, nk, 0);
      vc.load(v, g, b, h, k0, nk, 0);
      for (int d0 = 0; d0 < D; d0 += kDC) {
        __syncthreads();  // the readers of the previous chunk are done
        kc.store(Kc);
        vc.store(Vc);
        __syncthreads();
        if (d0 + kDC < D) {  // in flight meanwhile
          kc.load(k, g, b, h, k0, nk, d0 + kDC);
          vc.load(v, g, b, h, k0, nk, d0 + kDC);
        }
        const float* kr = Kc + j * kLd;
        const float* vr = Vc + j * kLd;
        const float* qr = Qs + grp * 4 * D + d0;
        const float* orow = Os + grp * 4 * D + d0;
        if (D - d0 >= kDC) {
#pragma unroll
          for (int dd = 0; dd < kDC; dd += 4) {
            const float k0v = kr[dd], k1v = kr[dd + 1], k2v = kr[dd + 2], k3v = kr[dd + 3];
            const float v0v = vr[dd], v1v = vr[dd + 1], v2v = vr[dd + 2], v3v = vr[dd + 3];
#pragma unroll
            for (int rr = 0; rr < 4; ++rr) {
              const float4 qv = *reinterpret_cast<const float4*>(qr + rr * D + dd);
              const float4 ov = *reinterpret_cast<const float4*>(orow + rr * D + dd);
              sa[rr] = fmaf(qv.x, k0v, sa[rr]);
              sa[rr] = fmaf(qv.y, k1v, sa[rr]);
              sa[rr] = fmaf(qv.z, k2v, sa[rr]);
              sa[rr] = fmaf(qv.w, k3v, sa[rr]);
              pa[rr] = fmaf(ov.x, v0v, pa[rr]);
              pa[rr] = fmaf(ov.y, v1v, pa[rr]);
              pa[rr] = fmaf(ov.z, v2v, pa[rr]);
              pa[rr] = fmaf(ov.w, v3v, pa[rr]);
            }
          }
        } else {
          for (int dd = 0; dd < D - d0; ++dd)
#pragma unroll
            for (int rr = 0; rr < 4; ++rr) {
              sa[rr] = fmaf(qr[rr * D + dd], kr[dd], sa[rr]);
              pa[rr] = fmaf(orow[rr * D + dd], vr[dd], pa[rr]);
            }
        }
      }
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int rq = grp * 4 + rr;
        float ds = 0.f;
        if (j < nk) {
          float sc = sa[rr] / sqd;
          if (causal && k0 + j > q0 + rq) sc = sc + kNegInf;
          ds = expf(sc - lse_s[rq]) * (pa[rr] - del_s[rq]);
        }
        Dt[j * BM + rq] = ds;
      }
      __syncthreads();
      // dQ += dS . K, K streamed from global memory by columns
      // the next key's columns of K are loaded before this key's FMAs
      const T* kp = k + row_off(g, b, k0, h) + c0;
      const int64_t step = g.H * g.D;
      float kn[CPT] = {};
      if (cols) load_cols(kp, kn);
      for (int jj = 0; jj < nk; ++jj) {
        float kv[CPT];
#pragma unroll
        for (int u = 0; u < CPT; ++u) kv[u] = kn[u];
        if (cols && jj + 1 < nk) load_cols(kp + (jj + 1) * step, kn);
        const float4* d4 = reinterpret_cast<const float4*>(Dt + jj * BM);
#pragma unroll
        for (int r4 = 0; r4 < BM / 4; ++r4) {
          const float4 ds = d4[r4];
#pragma unroll
          for (int u = 0; u < CPT; ++u) {
            dqa[4 * r4 + 0][u] = fmaf(ds.x, kv[u], dqa[4 * r4 + 0][u]);
            dqa[4 * r4 + 1][u] = fmaf(ds.y, kv[u], dqa[4 * r4 + 1][u]);
            dqa[4 * r4 + 2][u] = fmaf(ds.z, kv[u], dqa[4 * r4 + 2][u]);
            dqa[4 * r4 + 3][u] = fmaf(ds.w, kv[u], dqa[4 * r4 + 3][u]);
          }
        }
      }
      __syncthreads();  // Dt and the chunks are rewritten by the next tile
    }
  }

#pragma unroll
  for (int rq = 0; rq < BM; ++rq) {
    if (rq >= nq || !cols) break;
    float y[CPT];
#pragma unroll
    for (int u = 0; u < CPT; ++u) y[u] = dqa[rq][u] / sqd;
    store_cols(dqo + row_off(g, b, q0 + rq, h) + c0, y);
  }
}

// -- launchers ----------------------------------------------------------------

template <typename F, typename... Args>
int run(F kern, int64_t blocks, size_t smem, cudaStream_t stream, Args... args) {
  if (blocks <= 0) return 0;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(smem));
  if (e != cudaSuccess) return int(e);
  kern<<<dim3(unsigned(blocks)), kThreads, smem, stream>>>(args...);
  return int(cudaGetLastError());
}

bool takes(int64_t D) { return D > 0 && D <= kMaxD && D % 4 == 0; }

// contiguous cols per thread: D <= 256 -> 1, <= 512 -> 2, <= 1024 -> 4
int cpt_of(int64_t D) { return D <= 256 ? 1 : (D <= 512 ? 2 : 4); }

Geo geo(int64_t B, int64_t T, int64_t H, int64_t D, int64_t sp, int64_t Dscale) {
  return Geo{B, T, H, D, sp, T / sp, Dscale};
}

template <typename T, int CPT>
int dq_t(const void* q, const void* k, const void* v, const void* dout, const float* lse,
         const float* delta, void* dqo, Geo g, int causal, cudaStream_t st) {
  const int64_t blocks = g.B * g.H * g.sp * ((g.tl + dq::BM - 1) / dq::BM);
  return run(attn_bwd_dq<T, CPT>, blocks, dq::smem_bytes(g.D), st, static_cast<const T*>(q),
             static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout), lse,
             delta, static_cast<T*>(dqo), g, causal);
}

}  // namespace

extern "C" {

int tb_attn_bwd_delta(const void* out, const void* dout, int dtype, float* delta, int64_t B,
                      int64_t T, int64_t H, int64_t D, void* stream) {
  const Geo g = geo(B, T, H, D, 1, D);
  const int64_t blocks = (B * T * H + kThreads / 32 - 1) / (kThreads / 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run(attn_bwd_delta<float>, blocks, 0, st, static_cast<const float*>(out),
               static_cast<const float*>(dout), delta, g);
  return run(attn_bwd_delta<__nv_bfloat16>, blocks, 0, st,
             static_cast<const __nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(dout),
             delta, g);
}

// f32 operands only (dtype 0): bf16 dQ runs on the tensor cores
int tb_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout, int dtype,
                   const float* lse, const float* delta, void* dqo, int64_t B, int64_t T,
                   int64_t H, int64_t D, int64_t Dscale, int64_t sp, int causal, void* stream) {
  if (dtype != 0 || !takes(D) || Dscale <= 0 || sp <= 0 || T % sp != 0)
    return int(cudaErrorInvalidValue);
  const Geo g = geo(B, T, H, D, sp, Dscale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int c = cpt_of(D);
  return c == 1 ? dq_t<float, 1>(q, k, v, dout, lse, delta, dqo, g, causal, st)
         : c == 2 ? dq_t<float, 2>(q, k, v, dout, lse, delta, dqo, g, causal, st)
                  : dq_t<float, 4>(q, k, v, dout, lse, delta, dqo, g, causal, st);
}

}  // extern "C"
