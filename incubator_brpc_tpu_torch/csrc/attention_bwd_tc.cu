// K3's backward products in bfloat16 on Hopper's tensor cores (sm_90a):
//
//   attn_bwd_dkdv_tc <- the gradient JAX's autodiff takes through
//                       incubator_brpc_tpu/models/ring_attention.py:48
//                       ring_attention (via _block_attn :35 and block_merge
//                       :81), for dK and dV of bf16 operands
//   attn_bwd_dq_tc   <- the same gradient, for dQ of bf16 operands (its
//                       note is above the kernel, further down)
//
// It computes what attn_bwd_dkdv (attention.cu) computes, and what
// ops/attention.py dkdv_plain states: for each key, over the hops in order
// (at hop r the keys of block s are held by rank i = (s + r) mod sp) and
// over the query rows of that rank that can see it,
//   S = Q.K^T / sqrtf(D) (+ the additive -1e30 causal mask),
//   P = expf(S - lse),  dP = dO.V^T,  dS = P * (dP - delta),
//   dV += P^T.dO,  dK += dS^T.Q,
// with dK divided by sqrtf(D) once at the store. Layouts: q, k, v, dout,
// dk, dv (B, T, H, D) bf16; lse, delta (B, H, T) f32. Hops are summed in
// order and nothing is shared across blocks: no atomics, the result is
// deterministic.
//
// Numerics stay the JAX function's, which computes in f32 on operands
// widened from bf16 (the fold's method, attention_tc.cu):
// - S and dP by mma.sync m16n8k16 bf16 with f32 accumulation: a product of
//   two bf16 values is exact in f32, so only the order of the sums differs.
// - P and dS in f32 on the CUDA cores; each is split into hi = bf16_rn(x)
//   and lo = bf16_rn(x - hi), and dV += P_hi^T.dO + P_lo^T.dO,
//   dK += dS_hi^T.Q + dS_lo^T.Q are two bf16 mmas each, accumulated in f32
//   (ops/attention.py split_bf16; one rounding of P and dS would miss the
//   f32 tolerance of dK and dV, tests/test_torch_ring_attention.py).
// - No fast math (ops/kernels.py NVCC_FLAGS): IEEE division and expf.
//
// What bounds it on the card: operations, barely. At the bench shape (B 4,
// T 1024, H 2, D 1024, causal) the four products are 34.4 GFLOP, 0.035 ms
// at the bf16 tensor-core peak (the split's extra products counted as no
// work), and the function must move 100.7 MB, 0.030 ms at HBM's rate.
// What holds it back is the SM's own pace, as in the fold: the
// f32 dK and dV of 16 keys at D = 1024 fill half the register file, so a
// block runs alone on its SM with 8 warps, and each 64-row query tile's Q
// and dO stream through it twice (below).
//
// Design.
// - A block is (b, h, key block s, 16-key tile): 256 threads (8 warps), one
//   block per SM. At D = 1024 the f32 accumulators dK and dV of 16 keys are
//   128 KB, half the register file: warp w holds dV (w even) or dK (w odd)
//   of all 16 keys over columns [32 (w >> 1), +32) of every 128-column
//   chunk, 128 registers a thread. The earliest key tiles (the most query
//   rows see them under the mask) start first.
// - Shared memory (217 KB at D = 1024): the K and V tiles stay resident as
//   bf16 (rows padded by 16 B, so ldmatrix's eight row addresses fall in
//   distinct bank groups). Q and dO of each 64-row query tile stream through
//   one cp.async ring of kStages stages, a stage holding one 128-column D
//   chunk of both (2 x 64 x 128 x 2 B = 32 KB), one commit group a stage.
//   Each step issues its copies after its products, the stream's position
//   kept by counters (as in the fold). Rows past a ragged end and columns
//   past D are zero-filled by the copy, so an absent row meets P = 0 and
//   dS = 0, never stale bytes; a D off the k-step (D % 16 != 0) reads its
//   last k-step's columns past D as those zeros, in the K and V tiles too
//   (their rows hold D rounded up to 16 columns); at D % 8 != 0 the copies
//   go 8 bytes at a time (tc_mma.cuh).
// - Two passes over each query tile. The dK/dV products need P and dS, and
//   these need the whole D reduction, so each tile's chunks stream twice:
//   pass 1 forms S^T = K.Q^T (warps w even) and dP^T = V.dO^T (w odd)
//   directly, K and V the A operand by ldmatrix, the Q and dO chunks the B
//   operand untransposed; warp w covers D slice w >> 1 of every chunk (2 of
//   its 8 k-steps) for all 16 x 64 scores, and the four slices' partial sums
//   meet in shared memory, added in slice order. Then P^T and dS^T, hi and
//   lo, as 16 x 64 bf16 in shared memory; each warp keeps the hi and lo
//   fragments of its product in registers for the whole of pass 2, where
//   they are the A operand against the dO (dV) or Q (dK) chunks read by
//   ldmatrix.trans, the four hi mmas ahead of the four lo ones. At the bench
//   shape that is 3,072 mmas a (block, tile) over some 4,350 such pairs, and
//   about 2 GB read from L2: the second pass is what a wgmma/TMA/cluster
//   form (Q and dO shared by the blocks of a cluster) would remove first.
//
// Plain C interface, loaded with ctypes by incubator_brpc_tpu_torch/ops/
// kernels.py. Each entry point launches on the given stream, allocates
// nothing, and returns the first CUDA error (0 on success), or
// cudaErrorInvalidValue for a head dimension it does not take (D % 4 != 0
// or D > 1024).

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc_mma.cuh"

namespace {

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
constexpr int BN = 16;                    // keys per block
constexpr int BM = 64;                    // query rows per tile
constexpr int kDC = 128;                  // D columns per ring stage
constexpr int kMaxD = 1024;
constexpr int kMaxChunks = kMaxD / kDC;   // 8
constexpr int kStages = 3;                // ring depth (each stage a Q and a dO chunk)
constexpr int kSlices = 4;                // D slices of the S^T and dP^T products
constexpr int kLdC = kDC + 8;             // bf16 row pitch of a ring chunk (272 B)
constexpr int kLdS = BM + 8;              // f32 row pitch of a partial S^T / dP^T
constexpr int kLdP = BM + 8;              // bf16 row pitch of P^T / dS^T hi and lo (144 B)
constexpr int kMatBytes = 2 * BM * kLdC;  // one chunk of Q or of dO
constexpr int kStageBytes = 2 * kMatBytes;
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

size_t smem_bytes(int64_t D) {
  return 2 * 2 * BN * (round16(D) + 8)      // K and V tiles, bf16
         + size_t(kStages) * kStageBytes    // Q/dO ring, bf16
         + 4 * 2 * kSlices * BN * kLdS      // partial S^T and dP^T, f32
         + 2 * 4 * BN * kLdP                // P^T and dS^T, hi and lo, bf16
         + 4 * 2 * BM;                      // lse, delta
}

// Fragment coordinates (tc_mma.cuh): lane = 4 gq + tq; an f32 accumulator
// holds rows gq and gq + 8, columns 2 tq and 2 tq + 1.
// kNarrow: D % 8 != 0, the copies go 8 bytes at a time.
template <bool kNarrow>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dkdv_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, Geo g,
                 int causal) {
  extern __shared__ __align__(16) unsigned char smem_bwd[];
  const int D = int(g.D);
  const int ldk = round16(D) + 8;  // K's and V's columns past D, up to the k-step, are zero
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_bwd);   // [BN][ldk]
  __nv_bfloat16* Vs = Ks + BN * ldk;                                 // [BN][ldk]
  __nv_bfloat16* Ring = Vs + BN * ldk;  // [kStages][Q, dO][BM][kLdC]
  float* Sp = reinterpret_cast<float*>(Ring + kStages * kStageBytes / 2);  // [2][kSlices][BN][kLdS]
  __nv_bfloat16* Pt = reinterpret_cast<__nv_bfloat16*>(Sp + 2 * kSlices * BN * kLdS);
  // Pt holds [P hi, P lo, dS hi, dS lo][BN][kLdP], each transposed: key-major
  float* lse_s = reinterpret_cast<float*>(Pt + 4 * BN * kLdP);  // [BM]
  float* del_s = lse_s + BM;                                     // [BM]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int64_t tiles = (g.tl + BN - 1) / BN;
  const int64_t bh = blockIdx.x % (g.B * g.H);
  const int64_t h = bh % g.H, b = bh / g.H;
  // the earliest key tiles (the most rows that see them) start first
  const int64_t pos = blockIdx.x / (g.B * g.H);
  const int64_t s = pos / tiles, kt = pos % tiles;
  const int64_t k0 = s * g.tl + kt * BN;  // global position of the tile's key 0
  const int nk = int(imin(BN, g.tl - kt * BN));
  const int nc = (D + kDC - 1) / kDC;      // D chunks of one Q or dO tile
  const int64_t rstride = g.H * g.D;       // elements from one position to the next

  // The query tiles this key tile meets, hop by hop: at hop r the rows of
  // rank (s + r) mod sp, from the first tile holding a row that sees key 0
  // (every tile when not causal). first_tile is -1 for a hop with none.
  const int64_t ntq = (g.tl + BM - 1) / BM;
  auto first_tile = [&](int64_t hop) -> int64_t {
    if (!causal) return 0;
    const int64_t first = k0 - (s + hop) % g.sp * g.tl;  // first row that sees key 0, rank-local
    return first >= g.tl ? -1 : (first > 0 ? first / BM : 0);
  };
  auto seek = [&](int64_t& hop, int64_t& qt) {  // on to the next tile that exists
    while (hop < g.sp && (qt < 0 || qt >= ntq))
      if (++hop < g.sp) qt = first_tile(hop);
  };
  int64_t hop0 = 0, qt0 = first_tile(0), ntiles = 0;
  seek(hop0, qt0);
  for (int64_t r = 0; r < g.sp; ++r) {
    const int64_t f = first_tile(r);
    ntiles += f < 0 ? 0 : ntq - f;
  }
  const int total = int(ntiles) * 2 * nc;  // ring stages: each tile's chunks, twice

  // The stream's next stage: chunk iss_c of the Q and dO rows of tile
  // (iss_hop, iss_qt), pass iss_pass, and one commit group for it (empty
  // past the end, so every step waits on the same count). Thread t copies
  // rows t / 16 + 16 it, columns 8 (t % 16) + [0, 8) of both.
  constexpr int kRowsPerPass = kThreads / (kDC / 8);  // 16
  const int cp_row = tid / (kDC / 8), cp_col = tid % (kDC / 8) * 8;
  const uint32_t ring0 = smem_u32(Ring + cp_row * kLdC + cp_col);
  int iss_n = 0, iss_c = 0, iss_pass = 0, iss_stage = 0;
  int64_t iss_hop = hop0, iss_qt = qt0;
  auto issue = [&]() {
    if (iss_n < total) {
      const int64_t r0 = (s + iss_hop) % g.sp * g.tl + iss_qt * BM;  // the tile's row 0
      const int rows = int(imin(BM, g.tl - iss_qt * BM)) - cp_row;
      const int col = iss_c * kDC + cp_col;
      const int64_t off = row_off(g, b, r0, h) + int64_t(cp_row) * rstride + col;
      const uint32_t dst = ring0 + iss_stage * kStageBytes;
#pragma unroll
      for (int it = 0; it < BM / kRowsPerPass; ++it) {
        const int64_t o = off + int64_t(it) * kRowsPerPass * rstride;
        const uint32_t d = dst + 2 * it * kRowsPerPass * kLdC;
        cp_cols8<kNarrow>(d, q + o, q, col, D, it * kRowsPerPass < rows);
        cp_cols8<kNarrow>(d + kMatBytes, dout + o, dout, col, D, it * kRowsPerPass < rows);
      }
      if (++iss_c == nc) {  // pass 1's chunks, then pass 2's, then the next tile's
        iss_c = 0;
        if (++iss_pass == 2) {
          iss_pass = 0;
          ++iss_qt;
          seek(iss_hop, iss_qt);
        }
      }
      iss_stage = iss_stage == kStages - 1 ? 0 : iss_stage + 1;
    }
    ++iss_n;
    cp_async_commit();
  };

  // the K and V tiles (keys past nk and columns past D zero) go with stage 0's group
  {
    const int per_row = round16(D) / 8;
    for (int e = tid; e < 2 * BN * per_row; e += kThreads) {
      const int mat = e / (BN * per_row), rem = e - mat * BN * per_row;
      const int r = rem / per_row, c8 = (rem - r * per_row) * 8;
      const __nv_bfloat16* x = mat ? v : k;
      cp_cols8<kNarrow>(smem_u32((mat ? Vs : Ks) + r * ldk + c8), x + row_off(g, b, k0 + r, h) + c8,
                        x, c8, D, r < nk);
    }
  }
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) issue();

  // dV (w even) or dK (w odd) of the 16 keys: acc[c][nt] holds keys gq (+ 8),
  // columns kDC c + 32 oc + 8 nt + 2 tq (+ 1)
  const int prod = warp & 1, oc = warp >> 1;
  float acc[kMaxChunks][4][4];
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[c][nt][u] = 0.f;

  const float sqd = sqrtf(float(g.Dscale));
  // shared addresses of this lane's ldmatrix rows (PTX ISA, ldmatrix). Pass
  // 1, warp w: A = K (w even) or V (w odd), keys (lane & 15), columns
  // 8 (lane >> 4); B = the Q or dO chunk, rows (lane & 7) + 8 (lane >> 4),
  // columns 8 ((lane >> 3) & 1). Pass 2: A = P^T or dS^T, keys (lane & 15),
  // rows 8 (lane >> 4); B = the dO or Q chunk, transposed: rows (lane & 7) +
  // 8 ((lane >> 3) & 1), columns 32 oc + 8 (lane >> 4).
  const int ds = oc;  // pass 1: this warp's D slice
  const uint32_t a_frag = smem_u32((prod ? Vs : Ks) + (lane & 15) * ldk + (lane >> 4) * 8);
  const uint32_t b_frag = smem_u32(Ring) + prod * kMatBytes +
                          2 * (((lane & 7) + (lane >> 4) * 8) * kLdC + ((lane >> 3) & 1) * 8);
  const uint32_t bt_frag = smem_u32(Ring) + (1 - prod) * kMatBytes +
                           2 * (((lane & 7) + ((lane >> 3) & 1) * 8) * kLdC + oc * 32 +
                                (lane >> 4) * 8);
  const uint32_t p_frag = smem_u32(Pt + 2 * prod * BN * kLdP + (lane & 15) * kLdP + (lane >> 4) * 8);

  int stage = 0;  // the stage of the next chunk to use
  int64_t hop = hop0, qt = qt0;
  for (int64_t n = 0; n < ntiles; ++n) {
    const int64_t q0 = (s + hop) % g.sp * g.tl + qt * BM;  // global position of the tile's row 0
    const int nq = int(imin(BM, g.tl - qt * BM));
    if (tid < BM) {  // the previous tile's readers passed a barrier since
      lse_s[tid] = tid < nq ? lse[stat_off(g, b, h, q0 + tid)] : 0.f;
      del_s[tid] = tid < nq ? delta[stat_off(g, b, h, q0 + tid)] : 0.f;
    }

    // -- pass 1: S^T = K . Q^T (w even) or dP^T = V . dO^T (w odd), 16 keys x
    // 64 rows, over this warp's D slice of every chunk
    float sacc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int u = 0; u < 4; ++u) sacc[nt][u] = 0.f;
    for (int c = 0; c < nc; ++c) {
      cp_async_wait<kStages - 2>();  // this step's stage has landed (this thread's part)
      __syncthreads();               // everyone's part; the previous step's stage is free
      const uint32_t xb = b_frag + stage * kStageBytes;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int kd = (2 * ds + kk) * 16;  // k-step within the chunk
        if (c * kDC + kd < D) {
          uint32_t a[4];
          ldsm_x4(a, a_frag + 2 * (c * kDC + kd));
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            uint32_t bx[4];
            ldsm_x4(bx, xb + 2 * (j * 16 * kLdC + kd));
            mma_bf16(sacc[2 * j], a, bx[0], bx[1]);
            mma_bf16(sacc[2 * j + 1], a, bx[2], bx[3]);
          }
        }
      }
      issue();  // into the previous step's stage
      stage = stage == kStages - 1 ? 0 : stage + 1;
    }
    {
      float* S = Sp + (prod * kSlices + ds) * BN * kLdS;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(S + (gq + hh * 8) * kLdS + nt * 8 + 2 * tq) =
              make_float2(sacc[nt][2 * hh], sacc[nt][2 * hh + 1]);
    }
    __syncthreads();

    // -- P and dS: thread t takes key t / 16, rows 4 (t % 16) + [0, 4); the
    // slices added in slice order; hi and lo of both, transposed
    {
      const int j = tid >> 4, r4 = (tid & 15) * 4;
      float sv[4], dpv[4];
#pragma unroll
      for (int sl = 0; sl < kSlices; ++sl) {
        const float4 x = *reinterpret_cast<const float4*>(Sp + (sl * BN + j) * kLdS + r4);
        const float4 y =
            *reinterpret_cast<const float4*>(Sp + ((kSlices + sl) * BN + j) * kLdS + r4);
        if (sl == 0) {
          sv[0] = x.x, sv[1] = x.y, sv[2] = x.z, sv[3] = x.w;
          dpv[0] = y.x, dpv[1] = y.y, dpv[2] = y.z, dpv[3] = y.w;
        } else {
          sv[0] += x.x, sv[1] += x.y, sv[2] += x.z, sv[3] += x.w;
          dpv[0] += y.x, dpv[1] += y.y, dpv[2] += y.z, dpv[3] += y.w;
        }
      }
      uint32_t out[4][2] = {};  // P hi, P lo, dS hi, dS lo: rows r4 + [0, 4), two a word
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = r4 + u;
        float p = 0.f, dsv = 0.f;  // no such key or row: weighs 0
        if (j < nk && r < nq) {
          float sc = sv[u] / sqd;
          if (causal && k0 + j > q0 + r) sc = sc + kNegInf;
          p = expf(sc - lse_s[r]);
          dsv = p * (dpv[u] - del_s[r]);
        }
        const __nv_bfloat16 ph = __float2bfloat16_rn(p), dh = __float2bfloat16_rn(dsv);
        const __nv_bfloat16 x[4] = {ph, __float2bfloat16_rn(p - __bfloat162float(ph)), dh,
                                    __float2bfloat16_rn(dsv - __bfloat162float(dh))};
#pragma unroll
        for (int m = 0; m < 4; ++m)
          out[m][u >> 1] |= uint32_t(__bfloat16_as_ushort(x[m])) << (16 * (u & 1));
      }
#pragma unroll
      for (int m = 0; m < 4; ++m)
        *reinterpret_cast<uint2*>(Pt + (m * BN + j) * kLdP + r4) = make_uint2(out[m][0], out[m][1]);
    }
    __syncthreads();

    // -- pass 2: dV += P_hi^T . dO + P_lo^T . dO (w even), dK += dS_hi^T . Q +
    // dS_lo^T . Q (w odd); this warp's hi and lo fragments stay in registers
    uint32_t ahi[BM / 16][4], alo[BM / 16][4];
#pragma unroll
    for (int ks = 0; ks < BM / 16; ++ks) {
      ldsm_x4(ahi[ks], p_frag + 2 * ks * 16);
      ldsm_x4(alo[ks], p_frag + 2 * (BN * kLdP + ks * 16));
    }
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      if (c < nc) {
        cp_async_wait<kStages - 2>();
        __syncthreads();
        const uint32_t xb = bt_frag + stage * kStageBytes;
        if (c * kDC + oc * 32 < D) {
#pragma unroll
          for (int ks = 0; ks < BM / 16; ++ks) {
            if (ks * 16 < nq) {  // past nq P = dS = 0 and the rows are zero
              uint32_t bx[2][4];
#pragma unroll
              for (int half = 0; half < 2; ++half)
                ldsm_x4_t(bx[half], xb + 2 * (ks * 16 * kLdC + half * 16));
              // the four hi products, then the four lo: no mma waits on the one before
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
                mma_bf16(acc[c][nt], ahi[ks], bx[nt >> 1][2 * (nt & 1)], bx[nt >> 1][2 * (nt & 1) + 1]);
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
                mma_bf16(acc[c][nt], alo[ks], bx[nt >> 1][2 * (nt & 1)], bx[nt >> 1][2 * (nt & 1) + 1]);
            }
          }
        }
        issue();
        stage = stage == kStages - 1 ? 0 : stage + 1;
      }
    }
    ++qt;
    seek(hop, qt);
  }
  cp_async_wait<0>();  // the groups left are empty, or K/V's when no tile was met

  __nv_bfloat16* dst = prod ? dk : dv;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = gq + hh * 8;
    if (key >= nk) continue;
    const int64_t row = row_off(g, b, k0 + key, h);
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = c * kDC + oc * 32 + nt * 8 + 2 * tq;
        if (col >= D) continue;
        float x0 = acc[c][nt][2 * hh], x1 = acc[c][nt][2 * hh + 1];
        if (prod) x0 = x0 / sqd, x1 = x1 / sqd;  // dK's scale, once
        *reinterpret_cast<__nv_bfloat162*>(dst + row + col) = __floats2bfloat162_rn(x0, x1);
      }
  }
}

// ---------------------------------------------------------------------------
// attn_bwd_dq_tc: dQ of bf16 operands. It computes what attn_bwd_dq_tf32
// (attention_bwd_tf32.cu) computes for f32 operands, and what
// ops/attention.py dq_plain states: for
// each query row of rank i, over the hops in order (at hop r the block held
// is (i - r) mod sp) and the keys of that block it can see,
//   S = Q.K^T / sqrtf(D) (+ the additive -1e30 causal mask),
//   P = expf(S - lse),  dP = dO.V^T,  dS = P * (dP - delta),  dQ += dS.K,
// with dQ divided by sqrtf(D) once at the store. Hops are summed in order,
// nothing is shared across blocks, no atomics: deterministic. Numerics are
// dK/dV's above: S and dP by bf16 mma.sync with f32 accumulation (exact
// products), dS in f32 on the CUDA cores, split into hi = bf16_rn(dS) and
// lo = bf16_rn(dS - hi), dQ += dS_hi.K + dS_lo.K as two bf16 mmas into one
// f32 sum (one rounding of dS would miss the f32 tolerance of dQ,
// tests/test_torch_ring_attention.py); IEEE division and expf.
//
// What bounds it on the card: operations, barely. At the bench shape (B 4,
// T 1024, H 2, D 1024, causal) its three products are 25.8 GFLOP, 0.0261 ms
// at the bf16 tensor-core peak (the split's extra product counted as no
// work); it must move 83.9 MB, 0.0250 ms at HBM's rate. What holds it back
// is dK/dV's limit: one block of 8 warps per SM (shared memory), and a cost
// for each ring step that neither the step's bytes nor the ring's depth set
// (PERF.md: halving the steps of pass 2 took 27 % off, a fourth stage
// nothing), while each key tile's K streams through twice (about 1.7 GB
// read from L2 at the bench shape).
//
// Design: dK/dV's with the roles of queries and keys swapped.
// - A block is (b, h, rank i, 16-row query tile): 256 threads (8 warps), one
//   block per SM. The latest query tiles (the most keys visible under the
//   mask) start first. Warp w holds dQ of the 16 rows over columns
//   [16 w, +16) of every 128-column chunk: 64 f32 registers a thread at
//   D = 1024.
// - Shared memory (207 KB at D = 1024): the tile's Q and dO stay resident as
//   bf16 (rows padded by 16 B, so ldmatrix's eight row addresses fall in
//   distinct bank groups). The 64-key tiles of K and V stream through one
//   cp.async ring of kStages stages, a stage holding one 128-column D chunk
//   of K and of V (pass 1) or two chunks of K (pass 2), one commit group a
//   stage; each step issues its copies after its products, the stream's
//   position kept by counters. Keys past a ragged end and columns past D
//   are zero-filled by the copies (8-byte copies at D % 8 != 0), so a
//   missing key meets dS = 0 and never stale bytes, and a D off the k-step
//   reads its last k-step's columns past D as zeros.
// - Two passes over each key tile, as dS needs the whole D reduction first:
//   pass 1 forms S = Q.K^T (w even) and dP = dO.V^T (w odd), Q and dO the A
//   operand by ldmatrix, the K and V chunks the B operand untransposed; warp
//   w covers D slice w >> 1 of every chunk (2 of its 8 k-steps) for all
//   16 x 64 scores, and the four slices' partial sums meet in shared memory,
//   added in slice order. Then dS, hi and lo, as 16 x 64 bf16 in shared
//   memory, row-major: pass 2's A operand. Each warp keeps the hi and lo
//   fragments in registers for the whole of pass 2, where the K chunks,
//   read by ldmatrix.trans, are the B operand; each k-step's hi products
//   come ahead of its lo ones. 2,048 mmas and 12 ring steps a (query tile,
//   key tile) pair at D = 1024, some 4,350 pairs at the bench shape.
// ---------------------------------------------------------------------------

namespace dq {
constexpr int BM = 16;                     // query rows per block
constexpr int BN = 64;                     // keys per tile
constexpr int kMatBytes = 2 * BN * kLdC;   // one chunk of K or of V
constexpr int kStageBytes = 2 * kMatBytes;
constexpr int kLdS = BN + 8;               // f32 row pitch of a partial S / dP
constexpr int kLdP = BN + 8;               // bf16 row pitch of dS hi and lo (144 B)

size_t smem_bytes(int64_t D) {
  return 2 * 2 * BM * (round16(D) + 8)      // Q and dO tiles, bf16
         + size_t(kStages) * kStageBytes    // K/V ring, bf16
         + 4 * 2 * kSlices * BM * kLdS      // partial S and dP, f32
         + 2 * 2 * BM * kLdP                // dS hi and lo, bf16
         + 4 * 2 * BM;                      // lse, delta
}
}  // namespace dq

// Fragment coordinates (tc_mma.cuh): lane = 4 gq + tq; an f32 accumulator
// holds rows gq and gq + 8, columns 2 tq and 2 tq + 1.
// kNarrow: D % 8 != 0, the copies go 8 bytes at a time.
template <bool kNarrow>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dq_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dqo, Geo g, int causal) {
  extern __shared__ __align__(16) unsigned char smem_dq[];
  const int D = int(g.D);
  const int ldq = round16(D) + 8;  // Q's and dO's columns past D, up to the k-step, are zero
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_dq);  // [BM][ldq]
  __nv_bfloat16* Os = Qs + dq::BM * ldq;                          // [BM][ldq] (dO)
  __nv_bfloat16* Ring = Os + dq::BM * ldq;  // [kStages][K, V][BN][kLdC]
  // partial S and dP: [2][kSlices][BM][kLdS]
  float* Sp = reinterpret_cast<float*>(Ring + kStages * dq::kStageBytes / 2);
  __nv_bfloat16* Ds = reinterpret_cast<__nv_bfloat16*>(Sp + 2 * kSlices * dq::BM * dq::kLdS);
  // Ds holds [dS hi, dS lo][BM][kLdP], row-major
  float* lse_s = reinterpret_cast<float*>(Ds + 2 * dq::BM * dq::kLdP);  // [BM]
  float* del_s = lse_s + dq::BM;                                         // [BM]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int64_t tiles = (g.tl + dq::BM - 1) / dq::BM;
  const int64_t bh = blockIdx.x % (g.B * g.H);
  const int64_t h = bh % g.H, b = bh / g.H;
  // the latest query tiles (the most keys visible under the mask) start first
  const int64_t pos = tiles * g.sp - 1 - blockIdx.x / (g.B * g.H);
  const int64_t i = pos / tiles, qt = pos % tiles;
  const int64_t q0 = i * g.tl + qt * dq::BM;  // global position of the tile's row 0
  const int nq = int(imin(dq::BM, g.tl - qt * dq::BM));
  const int nc = (D + kDC - 1) / kDC;  // D chunks of one K or V tile
  const int64_t rstride = g.H * g.D;   // elements from one position to the next

  // The key tiles this query tile meets, hop by hop: at hop r those of block
  // (i - r) mod sp, up to the last holding a key its rows see (every tile
  // when not causal); none for a block wholly in the rows' future.
  const int64_t nkt = (g.tl + dq::BN - 1) / dq::BN;
  auto kbase = [&](int64_t hop) { return ((i - hop) % g.sp + g.sp) % g.sp * g.tl; };
  auto key_tiles = [&](int64_t hop) -> int64_t {
    if (!causal) return nkt;
    const int64_t last = q0 + nq - 1 - kbase(hop);  // the last key the rows see, block-local
    return last < 0 ? 0 : imin(nkt, last / dq::BN + 1);
  };
  auto seek = [&](int64_t& hop, int64_t& kt) {  // on to the next tile that exists
    while (hop < g.sp && kt >= key_tiles(hop)) {
      ++hop;
      kt = 0;
    }
  };
  int64_t hop0 = 0, kt0 = 0, ntiles = 0;
  seek(hop0, kt0);
  for (int64_t r = 0; r < g.sp; ++r) ntiles += key_tiles(r);
  const int nc2 = (nc + 1) / 2;              // pass 2's stages: two K chunks each
  const int total = int(ntiles) * (nc + nc2);  // ring stages of every tile's two passes

  // The stream's next stage and one commit group for it (empty past the
  // end, so every step waits on the same count): in pass 1 chunk iss_c of
  // the K and V rows of tile (iss_hop, iss_kt), in pass 2 chunks 2 iss_c
  // and 2 iss_c + 1 of its K rows (a chunk past D is zero-filled). Thread t
  // copies rows t / 16 + 16 it, columns 8 (t % 16) + [0, 8) of both.
  constexpr int kRowsPerPass = kThreads / (kDC / 8);  // 16
  const int cp_row = tid / (kDC / 8), cp_col = tid % (kDC / 8) * 8;
  const uint32_t ring0 = smem_u32(Ring + cp_row * kLdC + cp_col);
  int iss_n = 0, iss_c = 0, iss_pass = 0, iss_stage = 0;
  int64_t iss_hop = hop0, iss_kt = kt0;
  int64_t iss_row = row_off(g, b, kbase(hop0) + kt0 * dq::BN, h);  // the tile's key 0
  auto issue = [&]() {
    if (iss_n < total) {
      const int rows = int(imin(dq::BN, g.tl - iss_kt * dq::BN)) - cp_row;
      const uint32_t dst = ring0 + iss_stage * dq::kStageBytes;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const __nv_bfloat16* x = iss_pass == 0 && m ? v : k;
        const int col = (iss_pass ? 2 * iss_c + m : iss_c) * kDC + cp_col;
        const int64_t off = iss_row + int64_t(cp_row) * rstride + col;
#pragma unroll
        for (int it = 0; it < dq::BN / kRowsPerPass; ++it)
          cp_cols8<kNarrow>(dst + m * dq::kMatBytes + 2 * it * kRowsPerPass * kLdC,
                            x + off + int64_t(it) * kRowsPerPass * rstride, x, col, D,
                            it * kRowsPerPass < rows);
      }
      if (++iss_c == (iss_pass ? nc2 : nc)) {  // pass 1's stages, pass 2's, the next tile's
        iss_c = 0;
        if (++iss_pass == 2) {
          iss_pass = 0;
          ++iss_kt;
          seek(iss_hop, iss_kt);
          if (iss_hop < g.sp) iss_row = row_off(g, b, kbase(iss_hop) + iss_kt * dq::BN, h);
        }
      }
      iss_stage = iss_stage == kStages - 1 ? 0 : iss_stage + 1;
    }
    ++iss_n;
    cp_async_commit();
  };

  // the Q and dO tiles (rows past nq and columns past D zero) go with stage 0's group
  {
    const int per_row = round16(D) / 8;
    for (int e = tid; e < 2 * dq::BM * per_row; e += kThreads) {
      const int mat = e / (dq::BM * per_row), rem = e - mat * dq::BM * per_row;
      const int r = rem / per_row, c8 = (rem - r * per_row) * 8;
      const __nv_bfloat16* x = mat ? dout : q;
      cp_cols8<kNarrow>(smem_u32((mat ? Os : Qs) + r * ldq + c8), x + row_off(g, b, q0 + r, h) + c8,
                        x, c8, D, r < nq);
    }
  }
  if (tid < dq::BM) {  // read after pass 1's first barrier
    lse_s[tid] = tid < nq ? lse[stat_off(g, b, h, q0 + tid)] : 0.f;
    del_s[tid] = tid < nq ? delta[stat_off(g, b, h, q0 + tid)] : 0.f;
  }
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) issue();

  // dQ of the 16 rows: acc[c][nt] holds rows gq (+ 8), columns
  // kDC c + 16 warp + 8 nt + 2 tq (+ 1)
  float acc[kMaxChunks][2][4];
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[c][nt][u] = 0.f;

  const float sqd = sqrtf(float(g.Dscale));
  // shared addresses of this lane's ldmatrix rows (PTX ISA, ldmatrix). Pass
  // 1, warp w: A = Q (w even) or dO (w odd), rows (lane & 15), columns
  // 8 (lane >> 4); B = the K or V chunk, keys (lane & 7) + 8 (lane >> 4),
  // columns 8 ((lane >> 3) & 1). Pass 2: A = dS hi or lo, rows (lane & 15),
  // keys 8 (lane >> 4); B = the K chunk, transposed: keys (lane & 7) +
  // 8 ((lane >> 3) & 1), columns 16 w + 8 (lane >> 4).
  const int prod = warp & 1, ds = warp >> 1;  // pass 1: S or dP, and this warp's D slice
  const uint32_t a_frag = smem_u32((prod ? Os : Qs) + (lane & 15) * ldq + (lane >> 4) * 8);
  const uint32_t b_frag = smem_u32(Ring) + prod * dq::kMatBytes +
                          2 * (((lane & 7) + (lane >> 4) * 8) * kLdC + ((lane >> 3) & 1) * 8);
  const uint32_t bt_frag = smem_u32(Ring) + 2 * (((lane & 7) + ((lane >> 3) & 1) * 8) * kLdC +
                                                 warp * 16 + (lane >> 4) * 8);
  const uint32_t d_frag = smem_u32(Ds + (lane & 15) * dq::kLdP + (lane >> 4) * 8);

  int stage = 0;  // the stage of the next chunk to use
  int64_t hop = hop0, kt = kt0;
  for (int64_t n = 0; n < ntiles; ++n) {
    const int64_t k0 = kbase(hop) + kt * dq::BN;  // global position of the tile's key 0
    const int nk = int(imin(dq::BN, g.tl - kt * dq::BN));

    // -- pass 1: S = Q . K^T (w even) or dP = dO . V^T (w odd), 16 rows x 64
    // keys, over this warp's D slice of every chunk
    float sacc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int u = 0; u < 4; ++u) sacc[nt][u] = 0.f;
    for (int c = 0; c < nc; ++c) {
      cp_async_wait<kStages - 2>();  // this step's stage has landed (this thread's part)
      __syncthreads();               // everyone's part; the previous step's stage is free
      const uint32_t xb = b_frag + stage * dq::kStageBytes;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int kd = (2 * ds + kk) * 16;  // k-step within the chunk
        if (c * kDC + kd < D) {
          uint32_t a[4];
          ldsm_x4(a, a_frag + 2 * (c * kDC + kd));
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            uint32_t bx[4];
            ldsm_x4(bx, xb + 2 * (j * 16 * kLdC + kd));
            mma_bf16(sacc[2 * j], a, bx[0], bx[1]);
            mma_bf16(sacc[2 * j + 1], a, bx[2], bx[3]);
          }
        }
      }
      issue();  // into the previous step's stage
      stage = stage == kStages - 1 ? 0 : stage + 1;
    }
    {
      float* S = Sp + (prod * kSlices + ds) * dq::BM * dq::kLdS;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(S + (gq + hh * 8) * dq::kLdS + nt * 8 + 2 * tq) =
              make_float2(sacc[nt][2 * hh], sacc[nt][2 * hh + 1]);
    }
    __syncthreads();

    // -- dS: thread t takes row t / 16, keys 4 (t % 16) + [0, 4); the slices
    // added in slice order; hi and lo
    {
      const int r = tid >> 4, k4 = (tid & 15) * 4;
      float sv[4], dpv[4];
#pragma unroll
      for (int sl = 0; sl < kSlices; ++sl) {
        const float4 x = *reinterpret_cast<const float4*>(Sp + (sl * dq::BM + r) * dq::kLdS + k4);
        const float4 y =
            *reinterpret_cast<const float4*>(Sp + ((kSlices + sl) * dq::BM + r) * dq::kLdS + k4);
        if (sl == 0) {
          sv[0] = x.x, sv[1] = x.y, sv[2] = x.z, sv[3] = x.w;
          dpv[0] = y.x, dpv[1] = y.y, dpv[2] = y.z, dpv[3] = y.w;
        } else {
          sv[0] += x.x, sv[1] += x.y, sv[2] += x.z, sv[3] += x.w;
          dpv[0] += y.x, dpv[1] += y.y, dpv[2] += y.z, dpv[3] += y.w;
        }
      }
      uint32_t out[2][2] = {};  // dS hi, dS lo: keys k4 + [0, 4), two a word
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int key = k4 + u;
        float dsv = 0.f;  // no such row or key: weighs 0
        if (r < nq && key < nk) {
          float sc = sv[u] / sqd;
          if (causal && k0 + key > q0 + r) sc = sc + kNegInf;
          dsv = expf(sc - lse_s[r]) * (dpv[u] - del_s[r]);
        }
        const __nv_bfloat16 hi = __float2bfloat16_rn(dsv);
        const __nv_bfloat16 lo = __float2bfloat16_rn(dsv - __bfloat162float(hi));
        out[0][u >> 1] |= uint32_t(__bfloat16_as_ushort(hi)) << (16 * (u & 1));
        out[1][u >> 1] |= uint32_t(__bfloat16_as_ushort(lo)) << (16 * (u & 1));
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
        *reinterpret_cast<uint2*>(Ds + (m * dq::BM + r) * dq::kLdP + k4) =
            make_uint2(out[m][0], out[m][1]);
    }
    __syncthreads();

    // -- pass 2: dQ += dS_hi . K + dS_lo . K over this warp's 16 columns of
    // every chunk, two chunks a stage; the hi and lo fragments stay in
    // registers
    uint32_t ahi[dq::BN / 16][4], alo[dq::BN / 16][4];
#pragma unroll
    for (int ks = 0; ks < dq::BN / 16; ++ks) {
      ldsm_x4(ahi[ks], d_frag + 2 * ks * 16);
      ldsm_x4(alo[ks], d_frag + 2 * (dq::BM * dq::kLdP + ks * 16));
    }
#pragma unroll
    for (int c2 = 0; c2 < kMaxChunks / 2; ++c2) {
      if (c2 < nc2) {
        cp_async_wait<kStages - 2>();
        __syncthreads();
        const uint32_t xb = bt_frag + stage * dq::kStageBytes;
        // this warp's columns of chunk 2 c2 + m lie before D (so the chunk exists)
        const bool live[2] = {2 * c2 * kDC + warp * 16 < D,
                              (2 * c2 + 1) * kDC + warp * 16 < D};
#pragma unroll
        for (int ks = 0; ks < dq::BN / 16; ++ks) {
          if (ks * 16 < nk) {  // past nk dS = 0 and the keys are zero
            uint32_t bx[2][4];
#pragma unroll
            for (int m = 0; m < 2; ++m)
              if (live[m]) ldsm_x4_t(bx[m], xb + m * dq::kMatBytes + 2 * ks * 16 * kLdC);
            // the four hi products, then the four lo: no mma waits on the one before
#pragma unroll
            for (int m = 0; m < 2; ++m)
              if (live[m]) {
                mma_bf16(acc[2 * c2 + m][0], ahi[ks], bx[m][0], bx[m][1]);
                mma_bf16(acc[2 * c2 + m][1], ahi[ks], bx[m][2], bx[m][3]);
              }
#pragma unroll
            for (int m = 0; m < 2; ++m)
              if (live[m]) {
                mma_bf16(acc[2 * c2 + m][0], alo[ks], bx[m][0], bx[m][1]);
                mma_bf16(acc[2 * c2 + m][1], alo[ks], bx[m][2], bx[m][3]);
              }
          }
        }
        issue();
        stage = stage == kStages - 1 ? 0 : stage + 1;
      }
    }
    ++kt;
    seek(hop, kt);
  }
  cp_async_wait<0>();  // the groups left are empty

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = gq + hh * 8;
    if (row >= nq) continue;
    const int64_t ro = row_off(g, b, q0 + row, h);
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = c * kDC + warp * 16 + nt * 8 + 2 * tq;
        if (col >= D) continue;
        *reinterpret_cast<__nv_bfloat162*>(dqo + ro + col) =
            __floats2bfloat162_rn(acc[c][nt][2 * hh] / sqd, acc[c][nt][2 * hh + 1] / sqd);
      }
  }
}

}  // namespace

extern "C" {

int tb_attn_bwd_dkdv_tc(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dk, void* dv, int64_t B,
                        int64_t T, int64_t H, int64_t D, int64_t Dscale, int64_t sp, int causal,
                        void* stream) {
  if (D <= 0 || D > kMaxD || D % 4 != 0 || Dscale <= 0 || sp <= 0 || T % sp != 0)
    return int(cudaErrorInvalidValue);
  const Geo g{B, T, H, D, sp, T / sp, Dscale};
  const int64_t blocks = B * H * sp * ((g.tl + BN - 1) / BN);
  if (blocks <= 0) return 0;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(D);
  const auto kern = D % 8 ? attn_bwd_dkdv_tc<true> : attn_bwd_dkdv_tc<false>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  kern<<<dim3(unsigned(blocks)), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), g, causal);
  return int(cudaGetLastError());
}

int tb_attn_bwd_dq_tc(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dqo, int64_t B, int64_t T,
                      int64_t H, int64_t D, int64_t Dscale, int64_t sp, int causal, void* stream) {
  if (D <= 0 || D > kMaxD || D % 4 != 0 || Dscale <= 0 || sp <= 0 || T % sp != 0)
    return int(cudaErrorInvalidValue);
  const Geo g{B, T, H, D, sp, T / sp, Dscale};
  const int64_t blocks = B * H * sp * ((g.tl + dq::BM - 1) / dq::BM);
  if (blocks <= 0) return 0;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const size_t smem = dq::smem_bytes(D);
  const auto kern = D % 8 ? attn_bwd_dq_tc<true> : attn_bwd_dq_tc<false>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  kern<<<dim3(unsigned(blocks)), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, delta,
      static_cast<__nv_bfloat16*>(dqo), g, causal);
  return int(cudaGetLastError());
}

}  // extern "C"
