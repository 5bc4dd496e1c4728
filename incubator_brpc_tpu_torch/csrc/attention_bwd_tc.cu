// K3's dK and dV in bfloat16 on Hopper's tensor cores (sm_90a):
//
//   attn_bwd_dkdv_tc <- the gradient JAX's autodiff takes through
//                       incubator_brpc_tpu/models/ring_attention.py:48
//                       ring_attention (via _block_attn :35 and block_merge
//                       :81), for dK and dV of bf16 operands
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

  const float sqd = sqrtf(float(D));
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

}  // namespace

extern "C" {

int tb_attn_bwd_dkdv_tc(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dk, void* dv, int64_t B,
                        int64_t T, int64_t H, int64_t D, int64_t sp, int causal, void* stream) {
  if (D <= 0 || D > kMaxD || D % 4 != 0 || sp <= 0 || T % sp != 0)
    return int(cudaErrorInvalidValue);
  const Geo g{B, T, H, D, sp, T / sp};
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

}  // extern "C"
