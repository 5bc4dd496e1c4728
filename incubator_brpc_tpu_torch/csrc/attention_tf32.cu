// K3's forward fold in float32 on Hopper's tensor cores (sm_90a), 3xTF32:
//
//   attn_fold_fwd_tf32 <- incubator_brpc_tpu/models/ring_attention.py:35 _block_attn
//                         + :81 block_merge, and on the last hop :131-133 (the
//                         divide by max(l, 1e-30) and the cast)
//
// It computes what attn_fold_fwd_tc (attention_tc.cu) computes for bf16
// operands, for f32 ones: one hop of the ring for every rank, folded into
// the running (m, l, o), and with `finalize` the output and lse. Layouts:
// q, k, v, out (B, T, H, D) f32; m, l, lse (B, H, T) f32; o (B, T, H, D) f32.
//
// Numerics stay the JAX function's, which computes in f32:
// - Both products run on mma.sync m16n8k8 tf32 with f32 accumulation. A
//   tf32 operand keeps 11 of f32's 24 significand bits, so every f32
//   operand x (Q, K, V and P) is split into hi = cvt.rna.tf32(x) and
//   lo = cvt.rna.tf32(x - hi), and each product is three tensor-core
//   products, the small terms first: S = Qhi.Klo + Qlo.Khi + Qhi.Khi and
//   O += Phi.Vlo + Plo.Vhi + Phi.Vhi (lo.lo dropped; hi + lo carries 22
//   bits of x). One tf32 product (hi.hi) alone misses the f32 tolerance of
//   o by far more than 10x at D = 1024; ops/attention.py split_tf32 is the
//   plain statement of the split.
// - The score is that sum divided by sqrtf(Dscale). The causal mask is an
//   additive -1e30 from global positions; the running max starts at -1e30;
//   keys past a ragged block end weigh 0; a key tile wholly in a row
//   tile's future is skipped (attention.cu's note says why that is exact).
// - P = expf(s - m) in f32, and l sums that unsplit f32 P.
// - No fast math (ops/kernels.py NVCC_FLAGS): IEEE division and expf.
//
// What bounds it on the card: operations. At the bench shape (B 4, T 1024,
// H 2, D 1024, causal) the two products are 17.2 GFLOP, as 3xTF32 51.6
// GFLOP of tf32 tensor-core work, 0.104 ms at 494.7 TFLOP/s dense; the
// function must move 167.8 MB, 0.050 ms at HBM's rate. The f32 FMAs of the
// CUDA-core fold this replaced were bound at 0.257 ms.
//
// Design: attn_fold_fwd_tc's, in f32.
// - A block is (b, h, rank i, 32-row query tile): 256 threads (8 warps),
//   one block per SM. At D = 1024, 32 rows of the f32 accumulator O are
//   128 KB, half the register file. The heaviest causal tiles start first.
// - Shared memory (225 KB): a cp.async ring of 7 stages, each a 64-column
//   D chunk of the Q tile with the same chunk of a 64-key K tile (32 + 64
//   rows x 64 x 4 B, 27 KB with the row padding), or a chunk of the V
//   tile. Q is not resident: in f32 it is 128 KB (split into hi and lo,
//   256 KB, over the 227 KB a block may have), which would leave room for
//   3 stages, 2 chunks in flight, and then the copies' latency set the
//   pace. So Q's chunk streams in with K's,
//   re-read from L2 for each key tile (a quarter more L2 traffic) and 6
//   chunks are in flight. Rows past a ragged end and columns past D are
//   zero-filled by the copy (src-size 0), so a masked key's P = 0 meets
//   V = 0, never stale bytes, and a k-step reaching past D adds zeros.
// - Fragment loads: tf32 fragments are read with ld.shared, not ldmatrix
//   (which moves 16-bit pieces), and split as they are loaded (Q and K for
//   S, V for P.V; P is split once, by the softmax). The mma's k-index
//   within a k-step is free to permute as long as A and B agree: lane
//   (gq, tq) takes k-indices tq and tq + 4 from columns 2 tq and 2 tq + 1,
//   one 8-byte load. Row pitches
//   of 8 mod 32 words put the 16 lanes of each half-warp on distinct banks
//   (Q, K and V alike). For V the n-index is permuted too: the two n-tiles
//   of a warp's 16 columns take columns 2 gq and 2 gq + 1 of a key row (one
//   8-byte load), so the lane's accumulators hold 4 consecutive columns of
//   its rows, stored and loaded as float4.
// - S: warp w owns keys [32 (w & 1), +32) of the tile for all 32 rows over
//   the D slice (w >> 1) of every chunk (2 of its 8 k-steps): 24 mmas per
//   k-step on 16 loaded values. The three products of the 8 accumulators go
//   term by term, so no mma waits on the one before it.
// - Accumulation: the tensor cores' f32 accumulation does not round to
//   nearest, and its error grows with the length of a chain of mmas into
//   one accumulator (one chain over all of D, 96 mmas, put the running max
//   past tests/test_torch_cuda.py's 1e-5 at the bench shape). So each chunk's
//   products start from zero and are then added in f32 on the CUDA cores:
//   S's into the warp's partial sums in shared memory (the four slices'
//   partial sums are added in slice order: deterministic, no atomics), P.V's
//   into O as O * alpha + P.V. No chain is longer than 6 mmas for S and 24
//   for O.
// - Online softmax on the CUDA cores in f32, warp w on rows 4w..4w+3, two
//   keys a lane; it writes P hi and lo (tf32) over the first two slices'
//   partial sums, each lane where it read, and each row's alpha.
// - O = O * alpha + P.V: warp w owns rows [16 (w & 1), +16) and columns
//   [16 (w >> 1), +16) of every 64-column chunk (16 chunks at D = 1024), and
//   keeps its P hi and lo fragments (64 registers) for all of them; V is
//   split as its fragments are loaded.
// - Each step issues its copies after its products (attention_tc.cu's
//   note says why).
// - Prologue: the carried (m, l, o) of hop > 0. Epilogue: o, m, l; on
//   finalize also out and lse.
//
// Plain C interface, loaded with ctypes by incubator_brpc_tpu_torch/ops/
// kernels.py. The entry point launches on the given stream, allocates
// nothing, and returns the first CUDA error (0 on success), or
// cudaErrorInvalidValue for a head dimension it does not take (D % 4 != 0
// or D > 1024).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "tc_mma.cuh"

namespace {

using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::imin;
using tc::lds2;
using tc::mma_tf32;
using tc::round16;
using tc::smem_u32;
using tc::split_tf32;

constexpr int kThreads = 256;             // 8 warps
constexpr int BM = 32;                    // query rows per block
constexpr int BN = 64;                    // keys per tile
constexpr int kDC = 64;                   // D columns per ring stage
constexpr int kMaxD = 1024;
constexpr int kMaxChunks = kMaxD / kDC;   // 16
constexpr int kStages = 7;                // ring depth
constexpr int kSlices = 4;                // D slices of the S product
constexpr int kLdC = kDC + 8;             // f32 row pitch of a ring stage (8 mod 32 words)
constexpr int kLdS = BN + 8;              // f32 row pitch of a partial S (and of P hi / lo)
constexpr int kStageFloats = (BM + BN) * kLdC;  // a Q and a K chunk, or a V chunk
constexpr float kNegInf = -1e30f;

struct Geo {
  int64_t B, T, H, D, sp, tl;  // tl = T / sp rows per rank
  int64_t Dscale;              // the scores divide by sqrtf(Dscale): D before zero columns
};

__device__ __forceinline__ int64_t row_off(const Geo& g, int64_t b, int64_t t, int64_t h) {
  return ((b * g.T + t) * g.H + h) * g.D;
}
__device__ __forceinline__ int64_t stat_off(const Geo& g, int64_t b, int64_t h, int64_t t) {
  return (b * g.H + h) * g.T + t;
}

constexpr size_t kSmemBytes = 4 * (size_t(kStages) * kStageFloats  // the ring
                                   + size_t(kSlices) * BM * kLdS   // partial S; P hi, lo
                                   + 3 * BM);                      // m, l, alpha

// -- the kernel -------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
attn_fold_fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ m_io,
                   float* __restrict__ l_io, float* __restrict__ o_io, float* __restrict__ out,
                   float* __restrict__ lse, Geo g, int64_t hop, int causal, int finalize) {
  extern __shared__ __align__(16) unsigned char smem_tf32[];
  const int D = int(g.D);
  float* Ring = reinterpret_cast<float*>(smem_tf32);  // [kStages][BM + BN][kLdC]
  float* Sp = Ring + kStages * kStageFloats;          // [kSlices][BM][kLdS]
  uint32_t* Ph = reinterpret_cast<uint32_t*>(Sp);    // [BM][kLdS] over slice 0
  uint32_t* Pl = Ph + BM * kLdS;                     // [BM][kLdS] over slice 1
  float* m_s = Sp + kSlices * BM * kLdS;             // [BM] running max
  float* l_s = m_s + BM;                             // [BM] running sum
  float* a_s = l_s + BM;                             // [BM] this tile's alpha

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int64_t tiles = (g.tl + BM - 1) / BM;
  const int64_t bh = blockIdx.x % (g.B * g.H);
  const int64_t h = bh % g.H, b = bh / g.H;
  // the latest row tiles (the most visible keys under the mask) start first
  const int64_t pos = tiles * g.sp - 1 - blockIdx.x / (g.B * g.H);
  const int64_t i = pos / tiles, qt = pos % tiles;
  const int64_t src = ((i - hop) % g.sp + g.sp) % g.sp;
  const int64_t q0 = i * g.tl + qt * BM;  // global position of the tile's row 0
  const int nq = int(imin(BM, g.tl - qt * BM));
  const int64_t kbase = src * g.tl;
  int64_t nkt = (g.tl + BN - 1) / BN;
  if (causal) {
    const int64_t last = q0 + nq - 1 - kbase;  // last visible key, block-local
    nkt = last < 0 ? 0 : imin(nkt, last / BN + 1);
  }
  if (nkt == 0 && !finalize) return;  // nothing to fold: the state stays

  const int nc = (D + kDC - 1) / kDC;      // D chunks of one K or V tile
  const int total = int(nkt) * 2 * nc;     // chunks through the ring: K then V, tile by tile
  const int64_t rstride = g.H * g.D;       // elements from one position to the next

  // The stream's next chunk into its stage, and one commit group for it
  // (empty past the end, so every step waits on the same count): for S the
  // Q chunk (rows [0, BM) of the stage) with the K chunk (rows [BM, BM +
  // BN)), for P.V the V chunk (rows [0, BN)). Thread t copies rows t / 16 +
  // 16 it, columns 4 (t % 16) + [0, 4); rows past a ragged end and columns
  // past D are zero-filled.
  constexpr int kRowsPerPass = kThreads / (kDC / 4);  // 16
  const int cp_row = tid / (kDC / 4), cp_col = tid % (kDC / 4) * 4;
  const int64_t kv0 = row_off(g, b, kbase, h) + int64_t(cp_row) * rstride + cp_col;
  const int64_t q_0 = row_off(g, b, q0, h) + int64_t(cp_row) * rstride + cp_col;
  const uint32_t ring0 = smem_u32(Ring + cp_row * kLdC + cp_col);
  int iss_n = 0, iss_kt = 0, iss_c = 0, iss_stage = 0;
  bool iss_k = true;
  auto rows_of = [&](uint32_t dst, const float* src, const float* base, int rows, bool col,
                     auto passes) {
#pragma unroll
    for (int it = 0; it < decltype(passes)::value; ++it) {
      const bool ok = col && it * kRowsPerPass < rows;
      cp_async16(dst + 4 * it * kRowsPerPass * kLdC, ok ? src + it * kRowsPerPass * rstride : base,
                 ok);
    }
  };
  auto issue = [&]() {
    if (iss_n < total) {
      const uint32_t dst = ring0 + iss_stage * kStageFloats * 4;
      const int64_t kv = kv0 + int64_t(iss_kt) * BN * rstride + iss_c * kDC;
      const int keys = int(imin(BN, g.tl - int64_t(iss_kt) * BN)) - cp_row;
      const bool col = iss_c * kDC + cp_col < D;
      if (iss_k) {
        rows_of(dst, q + q_0 + iss_c * kDC, q, nq - cp_row, col,
                std::integral_constant<int, BM / kRowsPerPass>());
        rows_of(dst + 4 * BM * kLdC, k + kv, k, keys, col,
                std::integral_constant<int, BN / kRowsPerPass>());
      } else {
        rows_of(dst, v + kv, v, keys, col, std::integral_constant<int, BN / kRowsPerPass>());
      }
      if (++iss_c == nc) {  // K's chunks, then V's, then the next tile's
        iss_c = 0;
        iss_kt += !iss_k;
        iss_k = !iss_k;
      }
      iss_stage = iss_stage == kStages - 1 ? 0 : iss_stage + 1;
    }
    ++iss_n;
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue();

  if (tid < BM) {
    const bool carried = hop > 0 && tid < nq;
    m_s[tid] = carried ? m_io[stat_off(g, b, h, q0 + tid)] : kNegInf;
    l_s[tid] = carried ? l_io[stat_off(g, b, h, q0 + tid)] : 0.f;
  }
  // O: warp w owns rows [16 om, +16) and columns [16 oc, +16) of every chunk,
  // om = w & 1, oc = w >> 1. With V's n-index permuted (n-tile j, column n
  // of the mma is column 2 n + j of the warp's 16), o[c][j] holds rows
  // 16 om + gq (+ 8) at columns kDC c + 16 oc + 4 tq + {j, 2 + j}: the lane's
  // four consecutive columns (o[c][0][0], o[c][1][0], o[c][0][1], o[c][1][1])
  // of row gq, and the same from [2], [3] for row gq + 8.
  const int om = warp & 1, oc = warp >> 1;
  float o[kMaxChunks][2][4];
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int col = c * kDC + oc * 16 + 4 * tq;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = om * 16 + gq + hh * 8;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (hop > 0 && r < nq && col < D)
        x = *reinterpret_cast<const float4*>(o_io + row_off(g, b, q0 + r, h) + col);
      o[c][0][2 * hh] = x.x;
      o[c][1][2 * hh] = x.y;
      o[c][0][2 * hh + 1] = x.z;
      o[c][1][2 * hh + 1] = x.w;
    }
  }

  const float sqd = sqrtf(float(g.Dscale));
  const int kh = warp & 1, ds = warp >> 1;  // S: this warp's key half and D slice
  int stage = 0;                            // the stage of the next chunk to use
  // this lane's fragment rows and columns: Q's A (rows gq (+ 8 + 16 mt),
  // columns 2 tq of each k-step), K's B (keys 32 kh + 8 nt + gq, the same
  // columns), V's B (keys tq (+ 4) of each k-step, columns 16 oc + 2 gq)
  const float* q_frag = Ring + gq * kLdC + 2 * tq;
  const float* k_frag = Ring + (BM + kh * 32 + gq) * kLdC + 2 * tq;
  const float* v_frag = Ring + tq * kLdC + oc * 16 + 2 * gq;
  for (int64_t kt = 0; kt < nkt; ++kt) {
    const int64_t k0 = kbase + kt * BN;
    const int nk = int(imin(BN, g.tl - kt * BN));

    // -- S = Q . K^T over the K chunks: this warp's 32 rows x 32 keys, its D
    // slice. Each chunk's products start from zero and are added to the
    // slice's partial sums in shared memory (f32, round to nearest), so no
    // tensor-core accumulation runs longer than one chunk's 6 mmas.
    float* S = Sp + ds * BM * kLdS + gq * kLdS + kh * 32 + 2 * tq;
    for (int c = 0; c < nc; ++c) {
      cp_async_wait<kStages - 2>();  // this step's chunk has landed (this thread's part)
      __syncthreads();               // everyone's part; the previous step's stage is free
      const float* kb = k_frag + stage * kStageFloats;
      const float* qb = q_frag + stage * kStageFloats;
      float sacc[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int u = 0; u < 4; ++u) sacc[mt][nt][u] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int dk = ds * 16 + kk * 8;  // k-step within the chunk
        if (c * kDC + dk < D) {
          uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const float2 x = lds2(qb + (mt * 16 + hh * 8) * kLdC + dk);
              split_tf32(x.x, ah[mt][hh], al[mt][hh]);
              split_tf32(x.y, ah[mt][2 + hh], al[mt][2 + hh]);
            }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const float2 x = lds2(kb + nt * 8 * kLdC + dk);
            split_tf32(x.x, bh[nt][0], bl[nt][0]);
            split_tf32(x.y, bh[nt][1], bl[nt][1]);
          }
          // the small terms first, term by term over the 8 accumulators
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma_tf32(sacc[mt][nt], ah[mt], bl[nt][0], bl[nt][1]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma_tf32(sacc[mt][nt], al[mt], bh[nt][0], bh[nt][1]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma_tf32(sacc[mt][nt], ah[mt], bh[nt][0], bh[nt][1]);
        }
      }
      // into this warp's partial sums (its own elements: no other thread's)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float2* p = reinterpret_cast<float2*>(S + (mt * 16 + hh * 8) * kLdS + nt * 8);
            float2 x = make_float2(sacc[mt][nt][2 * hh], sacc[mt][nt][2 * hh + 1]);
            if (c > 0) {
              const float2 y = *p;
              x = make_float2(y.x + x.x, y.y + x.y);
            }
            *p = x;
          }
      issue();  // into the previous step's stage
      stage = stage == kStages - 1 ? 0 : stage + 1;
    }
    __syncthreads();

    // -- online softmax: warp w updates rows 4w .. 4w + 3, two keys a lane,
    // the four rows' steps interleaved (their reductions are independent)
    constexpr int kRows = BM / (kThreads / 32);
    float s[kRows][2], mx[kRows], sum[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int r = warp * kRows + rr;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = lane + 32 * u;
        const float* sp = Sp + r * kLdS + j;
        const float acc = ((sp[0] + sp[BM * kLdS]) + sp[2 * BM * kLdS]) + sp[3 * BM * kLdS];
        s[rr][u] = -INFINITY;  // no such key: weighs exp(-inf) = 0
        if (j < nk) {
          s[rr][u] = acc / sqd;
          if (causal && k0 + j > q0 + r) s[rr][u] = s[rr][u] + kNegInf;
        }
      }
      mx[rr] = fmaxf(s[rr][0], s[rr][1]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr)
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], off));
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int r = warp * kRows + rr;
      mx[rr] = fmaxf(m_s[r], mx[rr]);  // the new running max
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float p = expf(s[rr][u] - mx[rr]);
        // over slices 0 and 1 of the partial S, where this lane read them
        split_tf32(p, Ph[r * kLdS + lane + 32 * u], Pl[r * kLdS + lane + 32 * u]);
        s[rr][u] = p;
      }
      sum[rr] = s[rr][0] + s[rr][1];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], off);
    if (lane < kRows) {
      const int r = warp * kRows + lane;
      float m_new = mx[0], total = sum[0];  // lane rr takes row rr's values
#pragma unroll
      for (int rr = 1; rr < kRows; ++rr)
        if (lane == rr) m_new = mx[rr], total = sum[rr];
      const float alpha = expf(m_s[r] - m_new);
      a_s[r] = alpha;
      l_s[r] = l_s[r] * alpha + total;
      m_s[r] = m_new;
    }
    __syncthreads();

    // -- O = O * alpha + P.V over the V chunks; this warp's 16 rows of P hi
    // and lo stay in registers for all of them
    uint32_t ph[BN / 8][4], pl[BN / 8][4];
#pragma unroll
    for (int ks = 0; ks < BN / 8; ++ks)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int off = (om * 16 + gq + (u & 1) * 8) * kLdS + ks * 8 + tq + (u >> 1) * 4;
        ph[ks][u] = Ph[off];
        pl[ks][u] = Pl[off];
      }
    // each chunk's products start from zero; O = O * alpha + them, per row
    const float alpha[2] = {a_s[om * 16 + gq], a_s[om * 16 + gq + 8]};
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      if (c < nc) {
        cp_async_wait<kStages - 2>();
        __syncthreads();
        const float* vb = v_frag + stage * kStageFloats;
        if (c * kDC + oc * 16 < D) {  // columns past D are never stored
          float pv[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int ks = 0; ks < BN / 8; ++ks) {
            if (ks * 8 < nk) {  // past nk P = 0 and V = 0
              // b0 of n-tiles 0 and 1 (key tq), then b1 (key tq + 4)
              const float2 x0 = lds2(vb + ks * 8 * kLdC), x1 = lds2(vb + (ks * 8 + 4) * kLdC);
              uint32_t bh[2][2], bl[2][2];
              split_tf32(x0.x, bh[0][0], bl[0][0]);
              split_tf32(x0.y, bh[1][0], bl[1][0]);
              split_tf32(x1.x, bh[0][1], bl[0][1]);
              split_tf32(x1.y, bh[1][1], bl[1][1]);
#pragma unroll
              for (int j = 0; j < 2; ++j) mma_tf32(pv[j], ph[ks], bl[j][0], bl[j][1]);
#pragma unroll
              for (int j = 0; j < 2; ++j) mma_tf32(pv[j], pl[ks], bh[j][0], bh[j][1]);
#pragma unroll
              for (int j = 0; j < 2; ++j) mma_tf32(pv[j], ph[ks], bh[j][0], bh[j][1]);
            }
          }
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int u = 0; u < 4; ++u) o[c][j][u] = o[c][j][u] * alpha[u >> 1] + pv[j][u];
        }
        issue();
        stage = stage == kStages - 1 ? 0 : stage + 1;
      }
    }
  }
  cp_async_wait<0>();  // the groups left are empty, or Q's when nothing was folded
  __syncthreads();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = om * 16 + gq + hh * 8;
    if (r >= nq) continue;
    const float lf = fmaxf(l_s[r], 1e-30f);
    const int64_t row = row_off(g, b, q0 + r, h);
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const int col = c * kDC + oc * 16 + 4 * tq;
      if (col >= D) continue;
      const float4 x = make_float4(o[c][0][2 * hh], o[c][1][2 * hh], o[c][0][2 * hh + 1],
                                   o[c][1][2 * hh + 1]);
      *reinterpret_cast<float4*>(o_io + row + col) = x;
      if (finalize)
        *reinterpret_cast<float4*>(out + row + col) =
            make_float4(x.x / lf, x.y / lf, x.z / lf, x.w / lf);
    }
  }
  if (tid < nq) {
    const int64_t so = stat_off(g, b, h, q0 + tid);
    m_io[so] = m_s[tid];
    l_io[so] = l_s[tid];
    if (finalize) lse[so] = m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
  }
}

}  // namespace

extern "C" {

int tb_attn_fold_fwd_tf32(const float* q, const float* k, const float* v, float* m, float* l,
                          float* o, float* out, float* lse, int64_t B, int64_t T, int64_t H,
                          int64_t D, int64_t Dscale, int64_t sp, int64_t hop, int causal,
                          int finalize, void* stream) {
  if (D <= 0 || D > kMaxD || D % 4 != 0 || Dscale <= 0 || sp <= 0 || T % sp != 0)
    return int(cudaErrorInvalidValue);
  const Geo g{B, T, H, D, sp, T / sp, Dscale};
  const int64_t blocks = B * H * sp * ((g.tl + BM - 1) / BM);
  if (blocks <= 0) return 0;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const size_t smem = kSmemBytes;
  cudaError_t e = cudaFuncSetAttribute(attn_fold_fwd_tf32,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  attn_fold_fwd_tf32<<<dim3(unsigned(blocks)), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(q, k, v, m, l, o, out, lse, g, hop,
                                                            causal, finalize);
  return int(cudaGetLastError());
}

}  // extern "C"
