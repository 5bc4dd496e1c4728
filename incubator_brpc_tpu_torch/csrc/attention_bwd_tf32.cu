// K3's dK/dV and dQ in float32 on Hopper's tensor cores (sm_90a), 3xTF32:
//
//   attn_bwd_dkdv_tf32 <- the gradient JAX's autodiff takes through
//                         incubator_brpc_tpu/models/ring_attention.py:48
//                         ring_attention (via _block_attn :35 and
//                         block_merge :81), for dK and dV of f32 operands
//   attn_bwd_dq_tf32   <- the same gradient, for dQ of f32 operands (its
//                         note is above the kernel, further down)
//
// It computes what ops/attention.py dkdv_plain states, and what the bf16
// attn_bwd_dkdv_tc (attention_bwd_tc.cu) computes for bf16 operands: for
// each key, over the hops in order (at hop r the keys of block s are held
// by rank i = (s + r) mod sp) and over the query rows of that rank that can
// see it,
//   S = Q.K^T / sqrtf(D) (+ the additive -1e30 causal mask),
//   P = expf(S - lse),  dP = dO.V^T,  dS = P * (dP - delta),
//   dV += P^T.dO,  dK += dS^T.Q,
// with dK divided by sqrtf(D) once at the store. Layouts: q, k, v, dout,
// dk, dv (B, T, H, D) f32; lse, delta (B, H, T) f32. Hops are summed in
// order and nothing is shared across blocks: no atomics, the result is
// deterministic.
//
// Numerics stay the JAX function's, which computes in f32:
// - All four products run on mma.sync m16n8k8 tf32 with f32 accumulation.
//   Every f32 operand x (K, V, Q and dO as their fragments are loaded; P
//   and dS once, when they are formed) is split into hi = cvt.rna.tf32(x)
//   and lo = cvt.rna.tf32(x - hi) (tc_mma.cuh split_tf32; ops/attention.py
//   split_tf32 states it), and each product is three tensor-core products,
//   the small terms first: a_hi.b_lo + a_lo.b_hi + a_hi.b_hi (lo.lo
//   dropped; hi + lo carries 22 bits of x).
// - P and dS in f32 on the CUDA cores: expf, IEEE division (no fast math,
//   ops/kernels.py NVCC_FLAGS).
//
// What bounds it on the card: operations, as 3xTF32. At the bench shape (B
// 4, T 1024, H 2, D 1024, causal) the four products are 34.4 GFLOP, 103.2
// GFLOP of tf32 tensor-core work, 0.209 ms at 494.7 TFLOP/s dense; the
// function must move 201.4 MB, 0.060 ms at HBM's rate. PERF.md has its
// time beside that bound. Builds with parts taken out (probes, not
// kept) placed the time: the stream of Q and dO (each 64-row query tile
// streams through each 16-key block twice, below: about 4.4 GB read from
// L2) took well under half of it, pass 1's products and pass 2's the rest:
// the latency of each step's loads and products between two barriers, 64
// steps a query tile, with one block of 8 warps an SM.
//
// Design: attn_bwd_dkdv_tc's, in f32.
// - A block is (b, h, key block s, 16-key tile): 256 threads (8 warps), one
//   block per SM. At D = 1024 the f32 accumulators dK and dV of 16 keys are
//   128 KB, half the register file: warp w holds dV (w even) or dK (w odd)
//   of all 16 keys over columns [8 (w >> 1), +8) of every 32-column chunk,
//   128 registers a thread. The earliest key tiles (the most query rows see
//   them under the mask) start first.
// - Shared memory (210 KB at D = 1024): the K and V tiles stay resident as
//   f32 (132 KB; split as their fragments are loaded, not kept split, which
//   would take 264 KB). Q and dO of each 64-row query tile stream through
//   one cp.async ring of 3 stages, a stage holding one 32-column D chunk of
//   both (20 KB), one commit group a stage. Rows past a ragged end and
//   columns past D are zero-filled by the copy (src-size 0), so an absent
//   row meets P = dS = 0 and a k-step reaching past D adds zeros; the K and
//   V rows hold D rounded up to 32 columns, zero past D. Row pitches of 8
//   mod 32 words (K, V, the ring) put the lanes of each fragment load on
//   distinct banks. (Streaming K and V with Q and dO in an 8-stage ring
//   instead, an eighth more bytes, ran slower in a probe.)
// - Two passes over each query tile, as P and dS need the whole D reduction
//   first. Pass 1: warps 0-3 form S^T = K.Q^T and warps 4-7 dP^T = V.dO^T,
//   warp w for query rows [16 (w & 3), +16) of the tile over all of D (no
//   partial sums to meet across warps); the K or V fragments are the A
//   operand, the Q or dO chunk the B operand, untransposed, the k-index
//   permuted (lane (gq, tq) takes k-indices tq and tq + 4 from columns 2 tq
//   and 2 tq + 1, one 8-byte load, in A and B alike). dP^T goes through
//   shared memory to the warp holding the same S^T elements, which forms P
//   and dS and writes them, split into tf32 hi and lo, in pass 2's A
//   fragment order: each lane's fragment of a k-step is one 16-byte load
//   (not held in registers, beside the 128 of the accumulators). Pass 2:
//   dV += P^T.dO (w even), dK += dS^T.Q (w odd), the dO or Q chunk the B
//   operand, split as loaded.
// - Accumulation: the tensor cores' f32 accumulation does not round to
//   nearest (PERF.md: one 96-mma chain put the f32 fold's running max
//   1.5e-5 off). So each chunk's products start from zero and are added in
//   f32 on the CUDA cores: S^T and dP^T over a 32-column chunk into the
//   warp's running sums, dV and dK of a chunk over the query tile's 64 rows
//   into the accumulators. Each of the three terms of 3xTF32 has its own
//   accumulator (and dV's and dK's, one for the even and one for the odd
//   k-steps), summed small terms first: chains of 4 mmas, six independent
//   ones a warp (one chain a sum, 12 and 24 mmas, ran as fast).
// - Code size: pass 2's loop over the chunks must be unrolled wherever it
//   indexes the accumulators (registers). Unrolled over all 32 chunks at
//   D = 1024, its code outgrew the instruction caches, and the kernel took
//   as long as the CUDA-core kernel it replaced (PERF.md, the first
//   form's run); so the loop is unrolled 4 chunks deep and the
//   accumulators rotate 4 places a turn (32 moves a chunk a thread).
// - L2 traffic: Q and dO of each (key tile, query tile) pair are read twice
//   (the two passes), 1 MB a pair at D = 1024. More keys a block would cut
//   it, but 16 keys' f32 dK and dV already take half the register file;
//   splitting D across blocks would repeat pass 1 in each; holding a query
//   tile for both passes takes 512 KB at 64 rows (and at 16 rows, with K
//   and V then streaming instead, the bytes a pair come out the same). So
//   the design keeps the bf16 kernel's layout and shape.
//
// Plain C interface, loaded with ctypes by incubator_brpc_tpu_torch/ops/
// kernels.py. Each entry point launches on the given stream, allocates
// nothing, and returns the first CUDA error (0 on success), or
// cudaErrorInvalidValue for a head dimension it does not take (D % 4 != 0
// or D > 1024).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "tc_mma.cuh"

namespace {

using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::imin;
using tc::lds2;
using tc::mma_tf32;
using tc::smem_u32;
using tc::split_tf32;

constexpr int kThreads = 256;             // 8 warps
constexpr int BN = 16;                    // keys per block
constexpr int BM = 64;                    // query rows per tile
constexpr int kDC = 32;                   // D columns per ring stage
constexpr int kMaxD = 1024;
constexpr int kMaxChunks = kMaxD / kDC;   // 32
constexpr int kGroup = 4;                 // pass 2's chunks a turn of its rolled loop
constexpr int kStages = 3;                // ring depth (each stage a Q and a dO chunk)
constexpr int kLdC = kDC + 8;             // f32 row pitch of a ring chunk (8 mod 32 words)
constexpr int kFrag = (BM / 8) * 32 * 4;  // P^T or dS^T, hi or lo, as pass 2's A fragments
constexpr int kMatFloats = BM * kLdC;     // one chunk of Q or of dO
constexpr int kStageFloats = 2 * kMatFloats;
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

// K's and V's row pitch: D rounded up to a chunk, 8 mod 32 words
__host__ __device__ __forceinline__ int kv_pitch(int64_t D) {
  return int((D + kDC - 1) / kDC * kDC) + 8;
}

size_t smem_bytes(int64_t D) {
  return 4 * (2 * size_t(BN) * kv_pitch(D)      // K and V tiles
              + size_t(kStages) * kStageFloats  // Q/dO ring
              + 4 * 2 * 4 * 32                  // dP^T, warps 4-7 to warps 0-3
              + 4 * kFrag                       // P^T and dS^T, hi and lo
              + 2 * BM);                        // lse, delta
}

// Fragment coordinates (tc_mma.cuh mma_tf32): lane = 4 gq + tq; an f32
// accumulator holds rows gq and gq + 8, columns 2 tq and 2 tq + 1.
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dkdv_tf32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dk, float* __restrict__ dv, Geo g, int causal) {
  extern __shared__ __align__(16) unsigned char smem_bwd_tf32[];
  const int D = int(g.D);
  const int ldk = kv_pitch(D);
  float* Ks = reinterpret_cast<float*>(smem_bwd_tf32);  // [BN][ldk]
  float* Vs = Ks + BN * ldk;                             // [BN][ldk]
  float* Ring = Vs + BN * ldk;                           // [kStages][Q, dO][BM][kLdC]
  float* Xch = Ring + kStages * kStageFloats;            // [4 warps][2][4][32 lanes]
  // Pf holds [P hi, P lo, dS hi, dS lo][k-step][lane][a0..a3]: each lane's
  // A fragment of a k-step of pass 2 is one 16-byte load
  uint32_t* Pf = reinterpret_cast<uint32_t*>(Xch + 4 * 2 * 4 * 32);
  float* lse_s = reinterpret_cast<float*>(Pf + 4 * kFrag);  // [BM]
  float* del_s = lse_s + BM;                                    // [BM]

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
  // rows t / 8 + 32 it, columns 4 (t % 8) + [0, 4) of both.
  constexpr int kRowsPerPass = kThreads / (kDC / 4);  // 32
  const int cp_row = tid / (kDC / 4), cp_col = tid % (kDC / 4) * 4;
  const uint32_t ring0 = smem_u32(Ring + cp_row * kLdC + cp_col);
  int iss_n = 0, iss_c = 0, iss_pass = 0, iss_stage = 0;
  int64_t iss_hop = hop0, iss_qt = qt0;
  auto issue = [&]() {
    if (iss_n < total) {
      const int64_t r0 = (s + iss_hop) % g.sp * g.tl + iss_qt * BM;  // the tile's row 0
      const int rows = int(imin(BM, g.tl - iss_qt * BM)) - cp_row;
      const int col = iss_c * kDC + cp_col;
      const int64_t off = row_off(g, b, r0, h) + int64_t(cp_row) * rstride + col;
      const uint32_t dst = ring0 + 4 * iss_stage * kStageFloats;
#pragma unroll
      for (int it = 0; it < BM / kRowsPerPass; ++it) {
        const bool ok = col < D && it * kRowsPerPass < rows;
        const int64_t o = off + int64_t(it) * kRowsPerPass * rstride;
        const uint32_t d = dst + 4 * it * kRowsPerPass * kLdC;
        cp_async16(d, ok ? q + o : q, ok);
        cp_async16(d + 4 * kMatFloats, ok ? dout + o : dout, ok);
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
    const int per_row = (ldk - 8) / 4;  // 16-byte copies a row
    for (int e = tid; e < 2 * BN * per_row; e += kThreads) {
      const int mat = e / (BN * per_row), rem = e - mat * BN * per_row;
      const int r = rem / per_row, c4 = (rem - r * per_row) * 4;
      const float* x = mat ? v : k;
      const bool ok = r < nk && c4 < D;
      cp_async16(smem_u32((mat ? Vs : Ks) + r * ldk + c4),
                 ok ? x + row_off(g, b, k0 + r, h) + c4 : x, ok);
    }
  }
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) issue();

  // pass 2: dV (w even) or dK (w odd) of the 16 keys; acc[c] holds keys gq
  // (+ 8), columns kDC c + 8 oc + 2 tq (+ 1)
  const int prod = warp & 1, oc = warp >> 1;
  float acc[kMaxChunks][4];
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[c][u] = 0.f;

  const float sqd = sqrtf(float(g.Dscale));
  // pass 1, warp w: A = K (w < 4) or V, keys gq (+ 8), columns 2 tq (+ 1) of
  // each k-step; B = the Q or dO chunk, rows 16 rw + 8 j + gq, the same
  // columns. Pass 2: A = P^T or dS^T, keys gq (+ 8), rows tq (+ 4) of each
  // k-step; B = the dO or Q chunk, rows tq (+ 4), column 8 oc + gq.
  const int mat = warp >> 2, rw = warp & 3;
  const float* a1_frag = (mat ? Vs : Ks) + gq * ldk + 2 * tq;
  const float* b1_frag = Ring + mat * kMatFloats + (rw * 16 + gq) * kLdC + 2 * tq;
  const uint4* a2_frag = reinterpret_cast<const uint4*>(Pf + 2 * prod * kFrag) + lane;
  const float* b2_frag = Ring + (1 - prod) * kMatFloats + tq * kLdC + oc * 8 + gq;
  float* xch = Xch + rw * 2 * 4 * 32 + lane;

  int stage = 0;  // the stage of the next chunk to use
  int64_t hop = hop0, qt = qt0;
  for (int64_t n = 0; n < ntiles; ++n) {
    const int64_t q0 = (s + hop) % g.sp * g.tl + qt * BM;  // global position of the tile's row 0
    const int nq = int(imin(BM, g.tl - qt * BM));
    if (tid < BM) {  // the previous tile's readers passed a barrier since
      lse_s[tid] = tid < nq ? lse[stat_off(g, b, h, q0 + tid)] : 0.f;
      del_s[tid] = tid < nq ? delta[stat_off(g, b, h, q0 + tid)] : 0.f;
    }

    // -- pass 1: S^T = K . Q^T (w < 4) or dP^T = V . dO^T (w >= 4), 16 keys x
    // this warp's 16 rows, over all of D; each chunk's 12-mma chains start
    // from zero and are added to sacc in f32
    float sacc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) sacc[j][u] = 0.f;
    for (int c = 0; c < nc; ++c) {
      cp_async_wait<kStages - 2>();  // this step's stage has landed (this thread's part)
      __syncthreads();               // everyone's part; the previous step's stage is free
      const float* xb = b1_frag + stage * kStageFloats;
      float part[2][3][4] = {};  // [n-tile][term hi.lo, lo.hi, hi.hi]
#pragma unroll
      for (int kk = 0; kk < kDC / 8; ++kk) {
        const int kd = kk * 8;  // k-step within the chunk
        if (c * kDC + kd < D) {
          uint32_t ah[4], al[4], bh[2][2], bl[2][2];
          const float* ab = a1_frag + c * kDC + kd;
          const float2 x0 = lds2(ab), x1 = lds2(ab + 8 * ldk);
          split_tf32(x0.x, ah[0], al[0]);
          split_tf32(x1.x, ah[1], al[1]);
          split_tf32(x0.y, ah[2], al[2]);
          split_tf32(x1.y, ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float2 y = lds2(xb + j * 8 * kLdC + kd);
            split_tf32(y.x, bh[j][0], bl[j][0]);
            split_tf32(y.y, bh[j][1], bl[j][1]);
          }
          // six independent chains: no mma waits on the one before it
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            mma_tf32(part[j][0], ah, bl[j][0], bl[j][1]);
            mma_tf32(part[j][1], al, bh[j][0], bh[j][1]);
            mma_tf32(part[j][2], ah, bh[j][0], bh[j][1]);
          }
        }
      }
      // the small terms first
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) sacc[j][u] += (part[j][0][u] + part[j][1][u]) + part[j][2][u];
      issue();  // into the previous step's stage
      stage = stage == kStages - 1 ? 0 : stage + 1;
    }

    // -- P and dS: warp w + 4 hands its dP^T to warp w, which holds S^T at
    // the same places; P^T and dS^T, hi and lo, into Pf: element (key, row) is
    // a[(key >> 3) + 2 ((row & 7) >> 2)] of lane 4 (key & 7) + (row & 3) in
    // k-step row >> 3
    if (mat == 1) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) xch[(j * 4 + u) * 32] = sacc[j][u];
    }
    __syncthreads();
    if (mat == 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int key = gq + 8 * hh, r = rw * 16 + j * 8 + 2 * tq;  // rows r, r + 1
          uint32_t out[4][2];  // P hi, P lo, dS hi, dS lo of the two rows
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int u = 2 * hh + e;
            float p = 0.f, dsv = 0.f;  // no such key or row: weighs 0
            if (key < nk && r + e < nq) {
              float sc = sacc[j][u] / sqd;
              if (causal && k0 + key > q0 + r + e) sc = sc + kNegInf;
              p = expf(sc - lse_s[r + e]);
              dsv = p * (xch[(j * 4 + u) * 32] - del_s[r + e]);
            }
            split_tf32(p, out[0][e], out[1][e]);
            split_tf32(dsv, out[2][e], out[3][e]);
            const int row = r + e;
            const int at = (row >> 3) * 128 + (4 * (key & 7) + (row & 3)) * 4 + (key >> 3) +
                           2 * ((row & 7) >> 2);
#pragma unroll
            for (int m = 0; m < 4; ++m) Pf[m * kFrag + at] = out[m][e];
          }
        }
    }
    __syncthreads();

    // -- pass 2: dV += P^T . dO (w even), dK += dS^T . Q (w odd), this warp's
    // 8 columns of each chunk; each chunk's products over the tile's rows
    // start from zero and are added to acc in f32. The chunk loop is unrolled
    // kGroup chunks deep, not kMaxChunks (see the note above): acc[0 ..
    // kGroup) are the current group's, and the accumulators rotate kGroup
    // places a group, kMaxChunks places a tile.
#pragma unroll 1
    for (int c0 = 0; c0 < kMaxChunks; c0 += kGroup) {
#pragma unroll
      for (int gi = 0; gi < kGroup; ++gi) {
        const int c = c0 + gi;
        if (c < nc) {
          cp_async_wait<kStages - 2>();
          __syncthreads();
          const float* xb = b2_frag + stage * kStageFloats;
          if (c * kDC + oc * 8 < D) {  // columns past D are never stored
            float part[2][3][4] = {};  // [k-steps even, odd][term hi.lo, lo.hi, hi.hi]
#pragma unroll
            for (int ks = 0; ks < BM / 8; ++ks) {
              if (ks * 8 < nq) {  // past nq P = dS = 0 and the rows are zero
                const uint4 h4 = a2_frag[ks * 32], l4 = a2_frag[kFrag / 4 + ks * 32];
                const uint32_t ah[4] = {h4.x, h4.y, h4.z, h4.w}, al[4] = {l4.x, l4.y, l4.z, l4.w};
                uint32_t bh[2], bl[2];
                split_tf32(xb[ks * 8 * kLdC], bh[0], bl[0]);
                split_tf32(xb[(ks * 8 + 4) * kLdC], bh[1], bl[1]);
                mma_tf32(part[ks & 1][0], ah, bl[0], bl[1]);
                mma_tf32(part[ks & 1][1], al, bh[0], bh[1]);
                mma_tf32(part[ks & 1][2], ah, bh[0], bh[1]);
              }
            }
#pragma unroll
            for (int u = 0; u < 4; ++u)
              acc[gi][u] += ((part[0][0][u] + part[0][1][u]) + part[0][2][u]) +
                            ((part[1][0][u] + part[1][1][u]) + part[1][2][u]);
          }
          issue();
          stage = stage == kStages - 1 ? 0 : stage + 1;
        }
      }
      float first[kGroup][4];
#pragma unroll
      for (int i = 0; i < kMaxChunks; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (i < kGroup) first[i][u] = acc[i][u];
          if (i + kGroup < kMaxChunks) acc[i][u] = acc[i + kGroup][u];
          else acc[i][u] = first[i + kGroup - kMaxChunks][u];
        }
    }
    ++qt;
    seek(hop, qt);
  }
  cp_async_wait<0>();  // the groups left are empty, or K/V's when no tile was met

  float* dst = prod ? dk : dv;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = gq + hh * 8;
    if (key >= nk) continue;
    const int64_t row = row_off(g, b, k0 + key, h);
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const int col = c * kDC + oc * 8 + 2 * tq;
      if (col >= D) continue;
      float x0 = acc[c][2 * hh], x1 = acc[c][2 * hh + 1];
      if (prod) x0 = x0 / sqd, x1 = x1 / sqd;  // dK's scale, once
      *reinterpret_cast<float2*>(dst + row + col) = make_float2(x0, x1);
    }
  }
}

// ---------------------------------------------------------------------------
// attn_bwd_dq_tf32 <- the same gradient, for dQ of f32 operands:
//   dQ += dS.K over the hops in order, dS = P * (dO.V^T - delta) as above,
//   divided by sqrtf(D) once at the store. Layouts as above; dq (B, T, H,
//   D) f32.
//
// Numerics: dK/dV's. S = Q.K^T, dP = dO.V^T and dS.K run on mma.sync
// m16n8k8 tf32 as three products each (a_hi.b_lo + a_lo.b_hi + a_hi.b_hi,
// every f32 operand split as its fragment is loaded; dS once, when it is
// formed), each D chunk's (pass 1) and each key tile's (pass 2) products
// starting from zero and added in f32 on the CUDA cores, one accumulator
// per term; P and dS in f32 with expf and IEEE division, the scale and the
// mask as attention.cu states them.
//
// What bounds it on the card: operations, as 3xTF32. At the bench shape
// (B 4, T 1024, H 2, D 1024, causal) the three products are 25.8 GFLOP,
// 77.3 GFLOP of tf32 work, 0.156 ms at 494.7 TFLOP/s; it must move
// chip_smoke.py dq_bytes (167.8 MB), 0.050 ms at HBM's rate.
//
// Design: attn_bwd_dq_tc's layout (attention_bwd_tc.cu), in f32, with the
// machinery of the dK/dV kernel above.
// - A block is (b, h, rank i, 16-row query tile): 256 threads (8 warps),
//   one block per SM. The latest query tiles (the most keys visible under
//   the mask) start first. At D = 1024 the f32 dQ of 16 rows is 64 KB, 64
//   registers a thread: warp w holds the 8 columns [8 (w & 3), +8) of every
//   32-column chunk of parity w >> 2.
// - Shared memory (201 KB at D = 1024): Q and dO resident as f32 (132 KB,
//   rows of D rounded up to 32 columns, zero past D, a pitch of 8 mod 32
//   words). The 64-key tiles of K and V stream through one cp.async ring of
//   3 stages of 20 KB, a stage holding one 32-column chunk of K and of V
//   (pass 1) or two chunks of K (pass 2), one commit group a stage. Keys
//   past a ragged end and columns past D are zero-filled by the copies
//   (src-size 0), so a missing key meets dS = 0 and never stale bytes.
// - Two passes over each key tile, as dS needs the whole D reduction first.
//   Pass 1: warps 0-3 form S = Q.K^T and warps 4-7 dP = dO.V^T, warp w for
//   keys [16 (w & 3), +16) over all of D (no partial sums to meet across
//   warps); Q or dO the A operand, the K or V chunk the B operand
//   untransposed, the k-index permuted alike in both (lane (gq, tq) takes
//   k-indices tq and tq + 4 from columns 2 tq and 2 tq + 1, one 8-byte
//   load). dP goes through shared memory to the warp holding the same S
//   elements, which forms P and dS and writes dS, split into tf32 hi and
//   lo, in pass 2's A fragment order; every warp then keeps all eight
//   k-steps' hi and lo fragments in registers for the whole of pass 2 (64
//   registers; read from shared memory a stage, they would cost four times
//   the K chunk's bytes). Pass 2: dQ += dS.K, the K chunk the B operand
//   read down its columns: a row pitch of 8 mod 32 words puts the lanes of
//   that strided load on distinct banks.
// - Code size: pass 2 indexes the accumulators by chunk, so its loop runs
//   rolled, kGroup chunk pairs a turn, with the accumulators rotated kGroup
//   places a turn (dK/dV's lesson: unrolled over every chunk, its code
//   outgrew the instruction caches).
// ---------------------------------------------------------------------------

namespace dq {
constexpr int BM = 16;                         // query rows per block
constexpr int BN = 64;                         // keys per tile
constexpr int kPairs = kMaxChunks / 2;         // pass 2's stages at D = 1024: two chunks each
constexpr int kMatFloats = BN * kLdC;          // one chunk of K or of V
constexpr int kStageFloats = 2 * kMatFloats;
constexpr int kFrag = (BN / 8) * 32 * 4;       // dS, hi or lo, as pass 2's A fragments

// Q's and dO's row pitch: D rounded up to a chunk, 8 mod 32 words (as kv_pitch)
size_t smem_bytes(int64_t D) {
  return 4 * (2 * size_t(BM) * kv_pitch(D)     // Q and dO tiles
              + size_t(kStages) * kStageFloats  // K/V ring
              + 4 * 2 * 4 * 32                  // dP, warps 4-7 to warps 0-3
              + 2 * kFrag                       // dS hi and lo
              + 2 * BM);                        // lse, delta
}
}  // namespace dq

// Fragment coordinates (tc_mma.cuh mma_tf32): lane = 4 gq + tq; an f32
// accumulator holds rows gq and gq + 8, columns 2 tq and 2 tq + 1.
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dq_tf32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dqo, Geo g, int causal) {
  extern __shared__ __align__(16) unsigned char smem_dq_tf32[];
  const int D = int(g.D);
  const int ldq = kv_pitch(D);
  float* Qs = reinterpret_cast<float*>(smem_dq_tf32);  // [BM][ldq]
  float* Os = Qs + dq::BM * ldq;                        // [BM][ldq] (dO)
  float* Ring = Os + dq::BM * ldq;                      // [kStages][K, V or K, K][BN][kLdC]
  float* Xch = Ring + kStages * dq::kStageFloats;       // [4 warps][2][4][32 lanes]
  // Df holds [dS hi, dS lo][k-step][lane][a0..a3]: each lane's A fragment
  // of a k-step of pass 2 is one 16-byte load
  uint32_t* Df = reinterpret_cast<uint32_t*>(Xch + 4 * 2 * 4 * 32);
  float* lse_s = reinterpret_cast<float*>(Df + 2 * dq::kFrag);  // [BM]
  float* del_s = lse_s + dq::BM;                                 // [BM]

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
  const int nc2 = (nc + 1) / 2;        // pass 2's stages: two K chunks each
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
  const int total = int(ntiles) * (nc + nc2);  // ring stages of every tile's two passes

  // The stream's next stage and one commit group for it (empty past the
  // end, so every step waits on the same count): in pass 1 chunk iss_c of
  // the K and V rows of tile (iss_hop, iss_kt), in pass 2 chunks 2 iss_c
  // and 2 iss_c + 1 of its K rows (a chunk past D is zero-filled). Thread t
  // copies rows t / 8 + 32 it, columns 4 (t % 8) + [0, 4) of both.
  constexpr int kRowsPerPass = kThreads / (kDC / 4);  // 32
  const int cp_row = tid / (kDC / 4), cp_col = tid % (kDC / 4) * 4;
  const uint32_t ring0 = smem_u32(Ring + cp_row * kLdC + cp_col);
  int iss_n = 0, iss_c = 0, iss_pass = 0, iss_stage = 0;
  int64_t iss_hop = hop0, iss_kt = kt0;
  auto issue = [&]() {
    if (iss_n < total) {
      const int64_t k0 = kbase(iss_hop) + iss_kt * dq::BN;  // the tile's key 0
      const int rows = int(imin(dq::BN, g.tl - iss_kt * dq::BN)) - cp_row;
      const uint32_t dst = ring0 + 4 * iss_stage * dq::kStageFloats;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float* x = iss_pass == 0 && m ? v : k;
        const int col = (iss_pass ? 2 * iss_c + m : iss_c) * kDC + cp_col;
        const int64_t off = row_off(g, b, k0, h) + int64_t(cp_row) * rstride + col;
#pragma unroll
        for (int it = 0; it < dq::BN / kRowsPerPass; ++it) {
          const bool ok = col < D && it * kRowsPerPass < rows;
          cp_async16(dst + 4 * (m * dq::kMatFloats + it * kRowsPerPass * kLdC),
                     ok ? x + off + int64_t(it) * kRowsPerPass * rstride : x, ok);
        }
      }
      if (++iss_c == (iss_pass ? nc2 : nc)) {  // pass 1's stages, pass 2's, the next tile's
        iss_c = 0;
        if (++iss_pass == 2) {
          iss_pass = 0;
          ++iss_kt;
          seek(iss_hop, iss_kt);
        }
      }
      iss_stage = iss_stage == kStages - 1 ? 0 : iss_stage + 1;
    }
    ++iss_n;
    cp_async_commit();
  };

  // the Q and dO tiles (rows past nq and columns past D zero) go with stage 0's group
  {
    const int per_row = (ldq - 8) / 4;  // 16-byte copies a row
    for (int e = tid; e < 2 * dq::BM * per_row; e += kThreads) {
      const int mat = e / (dq::BM * per_row), rem = e - mat * dq::BM * per_row;
      const int r = rem / per_row, c4 = (rem - r * per_row) * 4;
      const float* x = mat ? dout : q;
      const bool ok = r < nq && c4 < D;
      cp_async16(smem_u32((mat ? Os : Qs) + r * ldq + c4),
                 ok ? x + row_off(g, b, q0 + r, h) + c4 : x, ok);
    }
  }
  if (tid < dq::BM) {  // read after pass 1's first barrier
    lse_s[tid] = tid < nq ? lse[stat_off(g, b, h, q0 + tid)] : 0.f;
    del_s[tid] = tid < nq ? delta[stat_off(g, b, h, q0 + tid)] : 0.f;
  }
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) issue();

  // dQ of the 16 rows: acc[c2] holds rows gq (+ 8), columns
  // kDC (2 c2 + half) + 8 nt + 2 tq (+ 1)
  const int half = warp >> 2, nt = warp & 3;
  float acc[dq::kPairs][4];
#pragma unroll
  for (int c = 0; c < dq::kPairs; ++c)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[c][u] = 0.f;

  const float sqd = sqrtf(float(g.Dscale));
  // pass 1, warp w: A = Q (w < 4) or dO, rows gq (+ 8), columns 2 tq (+ 1)
  // of each k-step; B = the K or V chunk, keys 16 rw + 8 j + gq, the same
  // columns. Pass 2: A = dS hi and lo, held; B = K chunk `half` of the
  // stage, keys tq (+ 4) of each k-step, column 8 nt + gq.
  const int mat = warp >> 2, rw = warp & 3;
  const float* a1_frag = (mat ? Os : Qs) + gq * ldq + 2 * tq;
  const float* b1_frag = Ring + mat * dq::kMatFloats + (rw * 16 + gq) * kLdC + 2 * tq;
  const uint4* d_frag = reinterpret_cast<const uint4*>(Df) + lane;
  const float* b2_frag = Ring + half * dq::kMatFloats + tq * kLdC + nt * 8 + gq;
  float* xch = Xch + rw * 2 * 4 * 32 + lane;

  int stage = 0;  // the stage of the next chunk to use
  int64_t hop = hop0, kt = kt0;
  for (int64_t n = 0; n < ntiles; ++n) {
    const int64_t k0 = kbase(hop) + kt * dq::BN;  // global position of the tile's key 0
    const int nk = int(imin(dq::BN, g.tl - kt * dq::BN));

    // -- pass 1: S = Q . K^T (w < 4) or dP = dO . V^T (w >= 4), 16 rows x
    // this warp's 16 keys, over all of D; each chunk's 12-mma chains start
    // from zero and are added to sacc in f32
    float sacc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) sacc[j][u] = 0.f;
    for (int c = 0; c < nc; ++c) {
      cp_async_wait<kStages - 2>();  // this step's stage has landed (this thread's part)
      __syncthreads();               // everyone's part; the previous step's stage is free
      const float* xb = b1_frag + stage * dq::kStageFloats;
      float part[2][3][4] = {};  // [n-tile][term hi.lo, lo.hi, hi.hi]
#pragma unroll
      for (int kk = 0; kk < kDC / 8; ++kk) {
        const int kd = kk * 8;  // k-step within the chunk
        if (c * kDC + kd < D) {
          uint32_t ah[4], al[4], bh[2][2], bl[2][2];
          const float* ab = a1_frag + c * kDC + kd;
          const float2 x0 = lds2(ab), x1 = lds2(ab + 8 * ldq);
          split_tf32(x0.x, ah[0], al[0]);
          split_tf32(x1.x, ah[1], al[1]);
          split_tf32(x0.y, ah[2], al[2]);
          split_tf32(x1.y, ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float2 y = lds2(xb + j * 8 * kLdC + kd);
            split_tf32(y.x, bh[j][0], bl[j][0]);
            split_tf32(y.y, bh[j][1], bl[j][1]);
          }
          // six independent chains: no mma waits on the one before it
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            mma_tf32(part[j][0], ah, bl[j][0], bl[j][1]);
            mma_tf32(part[j][1], al, bh[j][0], bh[j][1]);
            mma_tf32(part[j][2], ah, bh[j][0], bh[j][1]);
          }
        }
      }
      // the small terms first
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) sacc[j][u] += (part[j][0][u] + part[j][1][u]) + part[j][2][u];
      issue();  // into the previous step's stage
      stage = stage == kStages - 1 ? 0 : stage + 1;
    }

    // -- dS: warp w + 4 hands its dP to warp w, which holds S at the same
    // places; dS, hi and lo, into Df: element (row, key) is a[(row >> 3) +
    // 2 ((key & 7) >> 2)] of lane 4 (row & 7) + (key & 3) in k-step key >> 3
    if (mat == 1) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) xch[(j * 4 + u) * 32] = sacc[j][u];
    }
    __syncthreads();
    if (mat == 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int row = gq + 8 * (u >> 1), key = rw * 16 + j * 8 + 2 * tq + (u & 1);
          float dsv = 0.f;  // no such row or key: weighs 0
          if (row < nq && key < nk) {
            float sc = sacc[j][u] / sqd;
            if (causal && k0 + key > q0 + row) sc = sc + kNegInf;
            dsv = expf(sc - lse_s[row]) * (xch[(j * 4 + u) * 32] - del_s[row]);
          }
          uint32_t hi, lo;
          split_tf32(dsv, hi, lo);
          const int at = (key >> 3) * 128 + (4 * (row & 7) + (key & 3)) * 4 + (row >> 3) +
                         2 * ((key & 7) >> 2);
          Df[at] = hi;
          Df[dq::kFrag + at] = lo;
        }
    }
    __syncthreads();

    // -- pass 2: dQ += dS . K over this warp's 8 columns of chunk 2 c2 +
    // half, each stage two chunks; each tile's products start from zero and
    // are added to acc in f32. The loop is unrolled kGroup stages deep, not
    // kPairs (see the note above): acc[0 .. kGroup) are the current group's,
    // and the accumulators rotate kGroup places a group, kPairs places a tile.
    uint32_t dh[dq::BN / 8][4], dl[dq::BN / 8][4];
#pragma unroll
    for (int ks = 0; ks < dq::BN / 8; ++ks) {
      const uint4 h4 = d_frag[ks * 32], l4 = d_frag[dq::kFrag / 4 + ks * 32];
      dh[ks][0] = h4.x, dh[ks][1] = h4.y, dh[ks][2] = h4.z, dh[ks][3] = h4.w;
      dl[ks][0] = l4.x, dl[ks][1] = l4.y, dl[ks][2] = l4.z, dl[ks][3] = l4.w;
    }
#pragma unroll 1
    for (int c0 = 0; c0 < dq::kPairs; c0 += kGroup) {
#pragma unroll
      for (int gi = 0; gi < kGroup; ++gi) {
        const int c2 = c0 + gi;
        if (c2 < nc2) {
          cp_async_wait<kStages - 2>();
          __syncthreads();
          const float* xb = b2_frag + stage * dq::kStageFloats;
          if ((2 * c2 + half) * kDC + nt * 8 < D) {  // columns past D are never stored
            float part[2][3][4] = {};  // [k-steps even, odd][term hi.lo, lo.hi, hi.hi]
#pragma unroll
            for (int ks = 0; ks < dq::BN / 8; ++ks) {
              if (ks * 8 < nk) {  // past nk dS = 0 and the keys are zero
                uint32_t bh[2], bl[2];
                split_tf32(xb[ks * 8 * kLdC], bh[0], bl[0]);
                split_tf32(xb[(ks * 8 + 4) * kLdC], bh[1], bl[1]);
                mma_tf32(part[ks & 1][0], dh[ks], bl[0], bl[1]);
                mma_tf32(part[ks & 1][1], dl[ks], bh[0], bh[1]);
                mma_tf32(part[ks & 1][2], dh[ks], bh[0], bh[1]);
              }
            }
#pragma unroll
            for (int u = 0; u < 4; ++u)
              acc[gi][u] += ((part[0][0][u] + part[0][1][u]) + part[0][2][u]) +
                            ((part[1][0][u] + part[1][1][u]) + part[1][2][u]);
          }
          issue();
          stage = stage == kStages - 1 ? 0 : stage + 1;
        }
      }
      float first[kGroup][4];
#pragma unroll
      for (int c = 0; c < dq::kPairs; ++c)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (c < kGroup) first[c][u] = acc[c][u];
          if (c + kGroup < dq::kPairs) acc[c][u] = acc[c + kGroup][u];
          else acc[c][u] = first[c + kGroup - dq::kPairs][u];
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
    for (int c2 = 0; c2 < dq::kPairs; ++c2) {
      const int col = (2 * c2 + half) * kDC + nt * 8 + 2 * tq;
      if (col >= D) continue;
      *reinterpret_cast<float2*>(dqo + ro + col) =
          make_float2(acc[c2][2 * hh] / sqd, acc[c2][2 * hh + 1] / sqd);  // the scale, once
    }
  }
}

}  // namespace

extern "C" {

int tb_attn_bwd_dkdv_tf32(const float* q, const float* k, const float* v, const float* dout,
                          const float* lse, const float* delta, float* dk, float* dv, int64_t B,
                          int64_t T, int64_t H, int64_t D, int64_t Dscale, int64_t sp, int causal,
                          void* stream) {
  if (D <= 0 || D > kMaxD || D % 4 != 0 || Dscale <= 0 || sp <= 0 || T % sp != 0)
    return int(cudaErrorInvalidValue);
  const Geo g{B, T, H, D, sp, T / sp, Dscale};
  const int64_t blocks = B * H * sp * ((g.tl + BN - 1) / BN);
  if (blocks <= 0) return 0;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(D);
  cudaError_t e = cudaFuncSetAttribute(attn_bwd_dkdv_tf32,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  attn_bwd_dkdv_tf32<<<dim3(unsigned(blocks)), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(q, k, v, dout, lse, delta, dk, dv, g,
                                                            causal);
  return int(cudaGetLastError());
}


int tb_attn_bwd_dq_tf32(const float* q, const float* k, const float* v, const float* dout,
                        const float* lse, const float* delta, float* dqo, int64_t B, int64_t T,
                        int64_t H, int64_t D, int64_t Dscale, int64_t sp, int causal,
                        void* stream) {
  if (D <= 0 || D > kMaxD || D % 4 != 0 || Dscale <= 0 || sp <= 0 || T % sp != 0)
    return int(cudaErrorInvalidValue);
  const Geo g{B, T, H, D, sp, T / sp, Dscale};
  const int64_t blocks = B * H * sp * ((g.tl + dq::BM - 1) / dq::BM);
  if (blocks <= 0) return 0;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const size_t smem = dq::smem_bytes(D);
  cudaError_t e = cudaFuncSetAttribute(attn_bwd_dq_tf32,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  attn_bwd_dq_tf32<<<dim3(unsigned(blocks)), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, dout, lse, delta, dqo, g, causal);
  return int(cudaGetLastError());
}

}  // extern "C"
