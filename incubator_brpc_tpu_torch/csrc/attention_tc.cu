// K3's forward fold in bfloat16 on Hopper's tensor cores (sm_90a):
//
//   attn_fold_fwd_tc <- incubator_brpc_tpu/models/ring_attention.py:35 _block_attn
//                       + :81 block_merge, and on the last hop :131-133 (the
//                       divide by max(l, 1e-30) and the cast)
//
// It computes what attn_fold_fwd (attention.cu) computes for bf16 operands:
// one hop of the ring for every rank, folded into the running (m, l, o),
// and with `finalize` the output and lse. Layouts as there: q, k, v, out
// (B, T, H, D) bf16; m, l, lse (B, H, T) f32; o (B, T, H, D) f32.
//
// Numerics stay the JAX function's, which computes in f32 on operands
// widened from bf16:
// - S = Q.K^T by mma.sync m16n8k16 bf16 with f32 accumulation. A product of
//   two bf16 values is exact in f32, so only the order of the sums differs.
//   The score is that sum divided by sqrtf(D).
// - The causal mask is an additive -1e30 from global positions; the running
//   max starts at -1e30; keys past a ragged block end weigh 0; a key tile
//   wholly in a row tile's future is skipped (see attention.cu's note).
// - P = expf(s - m) in f32, and l sums that unsplit f32 P.
// - P.V: P is an f32 probability, and one rounding to bf16 would miss the
//   f32 tolerance of o by ~77x at D = 1024. So P is split into
//   hi = bf16_rn(P) and lo = bf16_rn(P - hi), and O += hi.V + lo.V are two
//   bf16 mmas accumulated in f32 (error ~1e-6 of max |o|; ops/attention.py
//   split_bf16 is the plain statement of it).
// - No fast math (ops/kernels.py NVCC_FLAGS): IEEE division and expf.
//
// What bounds it on the card: bytes. At the bench shape (B 4, T 1024, H 2,
// D 1024, causal) the two products are 17.2 GFLOP, 0.0174 ms at the bf16
// tensor-core peak, and the function must move 100.7 MB, 0.030 ms at HBM's
// rate. What holds it back is the SM's own pace: at D = 1024 the f32
// accumulator of 32 rows fills half the register file, so a block holds
// only 32 rows, runs alone on its SM with 8 warps (two per scheduler, too
// few to hide the latency of ldmatrix and mma.sync), and re-reads every K/V
// tile for those 32 rows; and a cp.async stalls its warp while the SM's
// copies in flight are at their limit. A block takes as long when 64
// blocks share the card as when 256 do, so it is not L2's bandwidth.
//
// Design. Items marked "changed" depart from a first layout (16 x 16 S warp
// tiles over the whole of D, each warp owning 16 columns of O for all 32
// rows, 3-4 stages, each step's copies issued before its products); each
// says why.
// - A block is (b, h, rank i, 32-row query tile): 256 threads (8 warps),
//   one block per SM. At D = 1024, 32 rows of the f32 accumulator O are
//   128 KB, half the register file (128 registers a thread), the most one
//   SM holds beside the rest. The heaviest causal tiles start first.
// - Shared memory (217 KB at D = 1024): the Q tile stays resident as bf16
//   (rows padded by 16 B, so ldmatrix's eight row addresses fall in
//   distinct bank groups); K and then V of each 64-key tile stream through
//   one cp.async ring of kStages 128-column D chunks (64 x 128 x 2 B =
//   16 KB a stage), one commit group per chunk. Changed: 6 stages, not 3-4;
//   4 and 6 ran alike, the depth is not the limit. Rows past a ragged end
//   and columns past D are zero-filled by the copy (src-size 0), so a
//   masked key's P = 0 meets V = 0, never stale bytes. A D off the k-step
//   (D % 16 != 0) reads its last k-step's columns past D as those zeros, in
//   the Q tile too (its rows hold D rounded up to 16 columns); at D % 8 != 0
//   the copies go 8 bytes at a time (tc_mma.cuh).
// - Changed: each step issues its copies after its products, its position
//   kept by counters rather than divided out of a chunk index, so neither
//   the address arithmetic nor a stalled cp.async stands between the
//   barrier and the step's ldmatrix and mma. Spreading the copies between
//   the products ran slower: a stalled copy then held back the mma behind
//   it.
// - S, changed: warp w owns keys [32 (w & 1), +32) of the tile for all 32
//   rows over the D slice (w >> 1) of every chunk (2 of its 8 k-steps):
//   8 mmas per k-step on 4 ldmatrix.x4, where a 16 x 16 warp tile over the
//   whole of D takes one ldmatrix per mma. The four slices' partial sums
//   meet in shared memory and are added in slice order (deterministic, no
//   atomics).
// - Online softmax on the CUDA cores in f32, warp w on rows 4w..4w+3, two
//   keys a lane, the four rows' reductions interleaved; it writes P hi and
//   lo as bf16 and each row's alpha.
// - O = O * alpha + P.V, changed: warp w owns rows [16 (w & 1), +16) and
//   columns [32 (w >> 1), +32) of every 128-column chunk (4 m16n8
//   fragments a chunk, 8 chunks), and keeps its P hi and lo fragments in
//   registers for all 8 chunks. Each V fragment (ldmatrix.trans from the
//   ring) is read by two warps, but P once a tile: 72 ldmatrix a tile and
//   warp, where owning 16 columns of all 32 rows takes 160. The four hi
//   products go before the four lo ones, so no mma waits on the one before
//   it.
// - Prologue: the carried (m, l, o) of hop > 0 into shared memory and the
//   fragments. Epilogue: o, m, l; on finalize also out (bf16) and lse.
// wgmma, TMA and clusters would go further (a producer that does not stall
// the mma warps, K/V shared by the blocks of a cluster); this is the
// mma.sync form.
//
// Plain C interface, loaded with ctypes by incubator_brpc_tpu_torch/ops/
// kernels.py. The entry point launches on the given stream, allocates
// nothing, and returns the first CUDA error (0 on success), or
// cudaErrorInvalidValue for a head dimension it does not take (D % 4 != 0
// or D > 1024).

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc_mma.cuh"

namespace {

using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::cp_cols8;
using tc::imin;
using tc::ldsm_x4;
using tc::ldsm_x4_t;
using tc::mma_bf16;
using tc::round16;
using tc::smem_u32;

constexpr int kThreads = 256;             // 8 warps
constexpr int BM = 32;                    // query rows per block
constexpr int BN = 64;                    // keys per tile
constexpr int kDC = 128;                  // D columns per ring stage
constexpr int kMaxD = 1024;
constexpr int kMaxChunks = kMaxD / kDC;   // 8
constexpr int kStages = 6;                // ring depth
constexpr int kSlices = 4;                // D slices of the S product
constexpr int kLdC = kDC + 8;             // bf16 row pitch of a ring stage (272 B)
constexpr int kLdP = BN + 8;              // bf16 row pitch of P hi / lo (144 B)
constexpr int kLdS = BN + 8;              // f32 row pitch of a partial S
constexpr int kStageBytes = 2 * BN * kLdC;
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

// -- the kernel -------------------------------------------------------------------

size_t smem_bytes(int64_t D) {
  return 2 * BM * (round16(D) + 8)           // Q tile, bf16
         + 2 * kStages * BN * kLdC           // K/V ring, bf16
         + 4 * kSlices * BM * kLdS           // partial S, f32
         + 2 * 2 * BM * kLdP                 // P hi and lo, bf16
         + 4 * 3 * BM;                       // m, l, alpha
}

// Fragment coordinates (PTX ISA, mma.m16n8k16): lane = 4 gq + tq. An f32
// accumulator holds rows gq and gq + 8, columns 2 tq and 2 tq + 1.
// kNarrow: D % 8 != 0, the copies go 8 bytes at a time (tc_mma.cuh).
template <bool kNarrow>
__global__ void __launch_bounds__(kThreads, 1)
attn_fold_fwd_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, float* __restrict__ m_io,
                 float* __restrict__ l_io, float* __restrict__ o_io,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse, Geo g, int64_t hop,
                 int causal, int finalize) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int D = int(g.D);
  const int ldq = round16(D) + 8;  // Q's columns past D, up to the k-step, are zero
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_tc);         // [BM][ldq]
  __nv_bfloat16* Ring = Qs + BM * ldq;                                     // [kStages][BN][kLdC]
  float* Sp = reinterpret_cast<float*>(Ring + kStages * BN * kLdC);       // [kSlices][BM][kLdS]
  __nv_bfloat16* Ph = reinterpret_cast<__nv_bfloat16*>(Sp + kSlices * BM * kLdS);  // [BM][kLdP]
  __nv_bfloat16* Pl = Ph + BM * kLdP;                                      // [BM][kLdP]
  float* m_s = reinterpret_cast<float*>(Pl + BM * kLdP);                  // [BM] running max
  float* l_s = m_s + BM;                                                   // [BM] running sum
  float* a_s = l_s + BM;                                                   // [BM] this tile's alpha

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
  // (empty past the end, so every step waits on the same count). The
  // stream's position advances by counters, not divisions: each step
  // issues after its own products, so this sits off their critical path.
  // Thread t copies rows t / 16 + 16 it, columns 8 (t % 16) + [0, 8).
  constexpr int kRowsPerPass = kThreads / (kDC / 8);  // 16
  const int cp_row = tid / (kDC / 8), cp_col = tid % (kDC / 8) * 8;
  const int64_t kv0 = row_off(g, b, kbase, h) + int64_t(cp_row) * rstride + cp_col;
  const uint32_t ring0 = smem_u32(Ring + cp_row * kLdC + cp_col);
  int iss_n = 0, iss_kt = 0, iss_c = 0, iss_stage = 0;
  bool iss_k = true;
  auto issue = [&]() {
    if (iss_n < total) {
      const __nv_bfloat16* x = iss_k ? k : v;
      const __nv_bfloat16* src = x + kv0 + int64_t(iss_kt) * BN * rstride + iss_c * kDC;
      const uint32_t dst = ring0 + iss_stage * kStageBytes;
      const int rows = int(imin(BN, g.tl - int64_t(iss_kt) * BN)) - cp_row;
      const bool col = iss_c * kDC + cp_col < D;
#pragma unroll
      for (int it = 0; it < BN / kRowsPerPass; ++it) {
        if constexpr (kNarrow) {
          cp_cols8<true>(dst + 2 * it * kRowsPerPass * kLdC, src + it * kRowsPerPass * rstride, x,
                         iss_c * kDC + cp_col, D, it * kRowsPerPass < rows);
        } else {  // as cp_cols8<false>, with the column test out of the loop (no spill)
          const bool ok = col && it * kRowsPerPass < rows;
          cp_async16(dst + 2 * it * kRowsPerPass * kLdC, ok ? src + it * kRowsPerPass * rstride : x,
                     ok);
        }
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

  // the Q tile (rows past nq and columns past D zero) goes with chunk 0's group
  {
    const int per_row = round16(D) / 8;
    for (int e = tid; e < BM * per_row; e += kThreads) {
      const int r = e / per_row, c8 = (e - r * per_row) * 8;
      cp_cols8<kNarrow>(smem_u32(Qs + r * ldq + c8), q + row_off(g, b, q0 + r, h) + c8, q, c8, D,
                        r < nq);
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue();

  if (tid < BM) {
    const bool carried = hop > 0 && tid < nq;
    m_s[tid] = carried ? m_io[stat_off(g, b, h, q0 + tid)] : kNegInf;
    l_s[tid] = carried ? l_io[stat_off(g, b, h, q0 + tid)] : 0.f;
  }
  // O: warp w owns rows [16 om, +16) and columns [32 oc, +32) of every chunk,
  // om = w & 1, oc = w >> 1; o[c][nt] holds rows 16 om + gq (+ 8), columns
  // kDC c + 32 oc + 8 nt + 2 tq (+ 1)
  const int om = warp & 1, oc = warp >> 1;
  float o[kMaxChunks][4][4];
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = c * kDC + oc * 32 + nt * 8 + 2 * tq;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = om * 16 + gq + hh * 8;
        float2 x = make_float2(0.f, 0.f);
        if (hop > 0 && r < nq && col < D)
          x = *reinterpret_cast<const float2*>(o_io + row_off(g, b, q0 + r, h) + col);
        o[c][nt][2 * hh] = x.x;
        o[c][nt][2 * hh + 1] = x.y;
      }
    }

  const float sqd = sqrtf(float(g.Dscale));
  const int kh = warp & 1, ds = warp >> 1;  // S: this warp's key half and D slice
  int stage = 0;                            // the stage of the next chunk to use
  // shared addresses of this lane's ldmatrix rows (PTX ISA, ldmatrix): Q's
  // A fragments (rows (lane & 15), columns 8 (lane >> 4)); K's B fragments,
  // keys 32 kh + (lane & 7) + 8 (lane >> 4), columns 8 ((lane >> 3) & 1);
  // V's, transposed: keys (lane & 7) + 8 ((lane >> 3) & 1), columns 32 oc + 8 (lane >> 4)
  const uint32_t q_frag = smem_u32(Qs + (lane & 15) * ldq + (lane >> 4) * 8);
  const uint32_t k_frag =
      smem_u32(Ring + (kh * 32 + (lane & 7) + (lane >> 4) * 8) * kLdC + ((lane >> 3) & 1) * 8);
  const uint32_t v_frag =
      smem_u32(Ring + ((lane & 7) + ((lane >> 3) & 1) * 8) * kLdC + oc * 32 + (lane >> 4) * 8);
  for (int64_t kt = 0; kt < nkt; ++kt) {
    const int64_t k0 = kbase + kt * BN;
    const int nk = int(imin(BN, g.tl - kt * BN));

    // -- S = Q . K^T over the K chunks: this warp's 32 rows x 32 keys, its D slice
    float sacc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int u = 0; u < 4; ++u) sacc[mt][nt][u] = 0.f;
    for (int c = 0; c < nc; ++c) {
      cp_async_wait<kStages - 2>();  // this step's chunk has landed (this thread's part)
      __syncthreads();               // everyone's part; the previous step's stage is free
      const uint32_t kb = k_frag + stage * kStageBytes;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int dk = (2 * ds + kk) * 16;  // k-step within the chunk
        if (c * kDC + dk < D) {
          uint32_t a[2][4], bk[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            ldsm_x4(a[mt], q_frag + 2 * (mt * 16 * ldq + c * kDC + dk));
#pragma unroll
          for (int half = 0; half < 2; ++half) ldsm_x4(bk[half], kb + 2 * (half * 16 * kLdC + dk));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              mma_bf16(sacc[mt][2 * half], a[mt], bk[half][0], bk[half][1]);
              mma_bf16(sacc[mt][2 * half + 1], a[mt], bk[half][2], bk[half][3]);
            }
        }
      }
      issue();  // into the previous step's stage
      stage = stage == kStages - 1 ? 0 : stage + 1;
    }
    {
      float* S = Sp + ds * BM * kLdS;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<float2*>(S + (mt * 16 + gq + hh * 8) * kLdS + kh * 32 + nt * 8 +
                                       2 * tq) =
                make_float2(sacc[mt][nt][2 * hh], sacc[mt][nt][2 * hh + 1]);
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
        const __nv_bfloat16 hi = __float2bfloat16_rn(p);
        Ph[r * kLdP + lane + 32 * u] = hi;
        Pl[r * kLdP + lane + 32 * u] = __float2bfloat16_rn(p - __bfloat162float(hi));
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

    // -- O = O * alpha + P_hi . V + P_lo . V over the V chunks; this warp's
    // 16 rows of P hi and lo stay in registers for all of them
    uint32_t ph[BN / 16][4], pl[BN / 16][4];
#pragma unroll
    for (int ks = 0; ks < BN / 16; ++ks) {
      const int off = (om * 16 + (lane & 15)) * kLdP + ks * 16 + (lane >> 4) * 8;
      ldsm_x4(ph[ks], smem_u32(Ph + off));
      ldsm_x4(pl[ks], smem_u32(Pl + off));
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float alpha = a_s[om * 16 + gq + hh * 8];
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          o[c][nt][2 * hh] *= alpha;
          o[c][nt][2 * hh + 1] *= alpha;
        }
    }
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      if (c < nc) {
        cp_async_wait<kStages - 2>();
        __syncthreads();
        const uint32_t vb = v_frag + stage * kStageBytes;
        if (c * kDC + oc * 32 < D) {
#pragma unroll
          for (int ks = 0; ks < BN / 16; ++ks) {
            if (ks * 16 < nk) {  // past nk P = 0 and V = 0
              uint32_t bv[2][4];
#pragma unroll
              for (int half = 0; half < 2; ++half)
                ldsm_x4_t(bv[half], vb + 2 * (ks * 16 * kLdC + half * 16));
              // the four hi products, then the four lo: no mma waits on the one before
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
                mma_bf16(o[c][nt], ph[ks], bv[nt >> 1][2 * (nt & 1)], bv[nt >> 1][2 * (nt & 1) + 1]);
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
                mma_bf16(o[c][nt], pl[ks], bv[nt >> 1][2 * (nt & 1)], bv[nt >> 1][2 * (nt & 1) + 1]);
            }
          }
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
    for (int c = 0; c < kMaxChunks; ++c)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = c * kDC + oc * 32 + nt * 8 + 2 * tq;
        if (col >= D) continue;
        const float x0 = o[c][nt][2 * hh], x1 = o[c][nt][2 * hh + 1];
        *reinterpret_cast<float2*>(o_io + row + col) = make_float2(x0, x1);
        if (finalize)
          *reinterpret_cast<__nv_bfloat162*>(out + row + col) =
              __floats2bfloat162_rn(x0 / lf, x1 / lf);
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

int tb_attn_fold_fwd_tc(const void* q, const void* k, const void* v, float* m, float* l,
                        float* o, void* out, float* lse, int64_t B, int64_t T, int64_t H,
                        int64_t D, int64_t Dscale, int64_t sp, int64_t hop, int causal,
                        int finalize, void* stream) {
  if (D <= 0 || D > kMaxD || D % 4 != 0 || Dscale <= 0 || sp <= 0 || T % sp != 0)
    return int(cudaErrorInvalidValue);
  const Geo g{B, T, H, D, sp, T / sp, Dscale};
  const int64_t blocks = B * H * sp * ((g.tl + BM - 1) / BM);
  if (blocks <= 0) return 0;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(D);
  const auto kern = D % 8 ? attn_fold_fwd_tc<true> : attn_fold_fwd_tc<false>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  kern<<<dim3(unsigned(blocks)), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), m, l, o, static_cast<__nv_bfloat16*>(out), lse, g,
      hop, causal, finalize);
  return int(cudaGetLastError());
}

}  // extern "C"
