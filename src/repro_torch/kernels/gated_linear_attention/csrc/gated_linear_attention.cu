// Chunked gated (decay) linear attention and its recompute backward, for
// sm_90a.
//
// Replaces repro/kernels/gated_linear_attention/kernel.py:
//   fwd (B8, _fwd_kernel; pallas_call at :98) -> gated_linear_attention_fwd
//   bwd (B9, _dq_kernel at :212, _dkv_kernel at :232, and its jnp dg
//        epilogue at :255-261)  -> gated_linear_attention_bwd_dq
//                                  gated_linear_attention_bwd_dkv
// and the backward of B8's exclusive form, which has no Pallas original
// (JAX trains RWKV-6 through jnp autodiff of chunked_gla(exclusive=True,
// u), repro/core/gated.py:156-215)
//                               -> gated_linear_attention_bwd_exclusive_dq
//                                  gated_linear_attention_bwd_exclusive_dkv
//
// The paper's §4 decay form, per (batch·head) row: with a_t = exp(g_t),
// g clamped to [min_log_decay, 0],
//     S_t = diag(a_t) S_{t-1} + k_t v_tᵀ ;   o_t = S_tᵀ q_t   (inclusive)
// or o_t = (S_{t-1} + diag(u) k_t v_tᵀ)ᵀ q_t (exclusive + u, RWKV-6).
// B9 returns dq, dk, dv and dg = reverse-cumsum(q⊙dq − k⊙dk), zero where
// the clamp held g. Only q, k, v, g and do are read: no state is stored,
// the paper's memory argument.
//
// The exclusive form's backward is B9's two sweeps with the strict mask
// and Q̂ = q e^{b_{t-1}}, plus the bonus: dq += (do·v) u⊙k, dk += (do·v)
// u⊙q, dv += (q·(u⊙k)) do, du[h] = Σ over the head's rows and t of (do·v)
// q⊙k. Its dg is not B9's: the query at t decays by b_{t-1}, so
//     dg_t = Σ_{s>t} q⊙dq_s − Σ_{s≥t} k⊙dk_s
// over the decay's shares of dq and dk alone (the bonus does not depend
// on g): B9's reverse sum less the token's own q⊙dq. The bf16 dq launch
// writes du per row (du_rows, fp32) and the caller sums each head's rows;
// the fp32 route forms dg and du in the wrapper, as B9's fp32 route forms
// dg.
//
// Two bodies.
//
// 1. fp32 FMAs (B8 and B9 in fp32): B2/B3's sweep with decay
// factors. A running fp32 state X (D×DS) from zero, for each tile of TC
// tokens with b the cumulative clamped log-decay FROM THE TILE'S START,
//     out = ((Â B̂ᵀ ⊙ M) Ĉ + Â X) ⊙ E_out ;  X ← (X + B̂ᵀ Ĉ) ⊙ E_tot
// where the hats scale an operand by exp(±b) per channel:
//   o  = sweep(q·e^{b}, k·e^{-b}, v) forward; X = S, rows × e^{btot}
//        (exclusive: q·e^{b_{t-1}}, strict M, plus the diagonal u bonus);
//   dq = sweep(do, v, k·e^{-b}) forward, out × e^{b}; X = Sᵀ, columns;
//   dk = sweep(v, do, q·e^{b}) reverse, out × e^{-b}; X = Rᵀ, columns;
//   dv = sweep(k·e^{-b}, q·e^{b}, do) reverse; X = R, rows
// (R = later tiles' Σ q̂ doᵀ; a reverse sweep decays X by its tile's
// e^{btot} before using it, where the forward sweep decays after the
// update). A reverse sweep walks the tiles last to first and loads each
// tile's rows reversed, which turns Mᵀ into M. dk and dv share one launch
// (blockIdx.z); dq and dk come out in fp32 and the wrapper forms dg. A
// block owns one row and one DS-column slice (DS = 64 at D = 128); the
// state slice stays in shared memory, each tile stages g's cumulative
// sum, the scaled operands and the C slice in fp32, and the products are
// register-tiled FMAs. Tiles are TC = 32 tokens (16 at D = 16): with g at
// its clamp (−1) |b| <= 32, every factor lies in [e^-32, e^32], and the
// carried state is only ever multiplied by e^{btot} <= 1, so the sweeps
// stay finite where the chunk-128 Pallas bodies and plain versions give
// inf and NaN.
//
// 2. bf16 B8 and B9 on the tensor cores (decay_sweep_fwd_tc;
// decay_sweep_dq_tc, decay_sweep_dkv_tc).
//
// The limit on min_log_decay. A tile of n tokens scales an operand by up
// to e^{n·|min_log_decay|} (K̂ = k e^{-b}) and sums n such products in
// fp32, whose largest exponent is 88.72. The wrappers (ops.py,
// DECAY_LIMIT) refuse min_log_decay < −1.25 in bf16: n·|min_log_decay| <=
// 80 for the 64-token tiles leaves e^8.7 ≈ 6,000 for the operands'
// magnitudes and the tile's sum. The 32-token fp32 tiles stay finite to
// −2.5 by the same rule, but fp32 dg, formed from dq and dk by the
// reverse-cumsum identity, carries their rounding times
// κ = max|q⊙dq| / max|dg|, which grows as the decay strengthens; fp32
// stops at −1.5, where dg stays within the route's 1e-5 of gla_scan.
//
// Bound. At the gated training main path's shape (128 rows, T = 1,024,
// D = 128; bf16 q, k, v, do; fp32 g) B8 reads q, k, v (100.7 MB) and g
// (67.1 MB) and writes o (33.6 MB) and the fp32 state (8.4 MB): 209.7 MB,
// 62.6 µs at 3.35 TB/s; its two products (S and o) take 8.6 GFLOP, 8.7
// µs on the tensor cores. B9 as a function reads q, k, v, do
// (134.2 MB) and g (67.1 MB) and writes dq, dk, dv (100.7 MB) and dg
// (67.1 MB): 369.1 MB, 110.2 µs at 3.35 TB/s. Its five products (the
// scan form's 2·T·D² per row each: S and dq; R, dk and dv) take 21.5
// GFLOP, 21.7 µs on the bf16 tensor cores. Bytes bound it. A forward and
// a reverse sweep each have to read the inputs, and q⊙dq has to pass
// from the first to the second in fp32, so two launches move at least
// 703.5 MB (210.0 µs): dq reads q, k, v, do, g and writes dq and q⊙dq;
// dk/dv reads q, k, v, do, g and q⊙dq and writes dk, dv and dg.
//
// Design.
// - Grid: one block of two warpgroups per row, walking the row's 64-token
//   tiles (wgmma's M) forward (B8, dq) or last to first (dk/dv). With the
//   default clamp of −1 a 64-token tile keeps |b| <= 64 and every e^{±b}
//   within [e^-64, e^64], finite in fp32 and in bf16 (the same exponent);
//   every product pairs an e^{-b} with an e^{+b} or a decayed state, so
//   no intermediate passes e^64 · |x| (e^80 · |x| at the limit above).
// - Loads: one thread issues TMA loads of a whole tile (q, k, v, do in
//   64-column bf16 blocks with the 128-byte swizzle, B8 without do; g in
//   32-column fp32 blocks, swizzled the same way) into a ring of two
//   stages, the next tile's during this tile's work; rows past T read as
//   zeros (log-decay 0: they add and decay nothing). Two stages of 96 KiB
//   and the state's copy take 224 KiB of the 227.
// - Head dims: D = 16, 64, 96, 112, 128. q, k, v and do are padded to DC
//   64-column blocks (one at D = 16 and 64, two at 96, 112 and 128), the
//   columns past D read as zeros (the tensor map is D wide: 224 bytes a
//   bf16 row at D = 112); g comes in GB = ⌈D/32⌉ blocks, so the decay
//   scans cover D channels (32 at D = 16, 128 at 112: the padded columns
//   read as g = 0). Past D nothing is scaled
//   (scale_slot and split_slot skip those columns, which stay zero), the
//   decay total stays 0 (a state row decays by 1), u is not read, dg is
//   not scanned and no output or state element is stored. At D = 96 the
//   padded block does a third more tensor-core work than D needs.
// - The cumulative log-decay of a tile is one scan along tokens per
//   channel (a thread per channel and half tile), kept in place of g in
//   log2 units, so each e^{±b} is one ex2. The scaled operands (K̂ = k e^{-b}
//   in every launch, Q̂ = q e^{b} in B8 and dk/dv) are written over the raw
//   tile in bf16 before the products.
// - Products: wgmma, bf16 operands, fp32 accumulators. The state (S for
//   B8 and dq, R for dk/dv, D×D fp32, [dk][dv]) lives in the accumulator
//   registers, its rows split over the two warpgroups (64 registers each
//   at D = 128); each tile a bf16 copy goes to shared memory as the
//   operand of the inter-tile products. dq: each warpgroup owns 64 columns
//   of dq and computes the 64×64 score tile dO Vᵀ itself (1 MFLOP on the
//   tensor cores: the ring leaves no room for a shared copy), then
//   P K̂ + dO Sᵀ with the state update K̂ᵀ V beside it. dk/dv: warpgroup 0
//   computes dk from the score tile V dOᵀ, warpgroup 1 dv from K̂ Q̂ᵀ, each
//   from one score tile and the one state copy, with the update Q̂ᵀ dO
//   beside; R is built once for both. Masks are applied to the score
//   accumulators in registers (M for dq, Mᵀ for the reverse sweep), and
//   each score tile enters its product as two bf16 parts (hi + lo), so
//   the scores are not rounded to 8 bits.
// - B8 has the shape of the dq launch, on (q, k, v): each warpgroup owns
//   64 columns of o and 64 rows of S, computes the score tile Q̂ K̂ᵀ itself
//   (masked to M; in the exclusive form to the strict triangle with the
//   bonus q·(u⊙k), summed from the raw tile before scaling, on its
//   diagonal), then o = P V + Q̂ S with the update S += K̂ᵀ V beside it, and
//   decays S's rows by e^{btot}; S is written in fp32 at the end. B8 has no
//   dg, so its score tile is one bf16 operand; its state update takes K̂ in
//   two bf16 parts (hi over k, lo in the stage's do slot, which B8 does
//   not load), so that the emitted state keeps fp32's accuracy (within
//   1e-5 of the plain version, as the FMA route's) where o reads the
//   state's bf16 copy.
// - Keeping ptxas from serializing the wgmmas (its C7515/C7520 notes):
//   the score tile is a group of its own, waited for before its masking
//   writes the next group's register operands; each group is straight-line
//   code (a branch inside an open group serializes it), and the warpgroup
//   index comes from a shuffle, so that ptxas sees it uniform. Offsets
//   derived from the thread index are recomputed in each tile, so that
//   the compiler does not hold them in registers across the tile loop
//   (the dk/dv launch spilled when it did).
// - Split operands (L<D>::kSplit, D <= 64: the SSD's and RWKV-6's head
//   dims): Q̂, K̂, the score tiles and the state copies enter every
//   product as hi + lo bf16 parts (about 16 bits; see L). With one part
//   these heads' strong decays left RWKV-6's groupnormed outputs and
//   Mamba-2's decay gradients a few percent off the fp32 plain version
//   in a bf16 training step (PERF.md §6).
// - The exclusive backward (EXCLUSIVE) at D = 96, 112 and 128: the strict
//   masks of its score tiles in two parts (mask_split_strict), dv's with
//   q·(u⊙k) on its diagonal; do·v and q·(u⊙k) of each token summed in
//   fp32 from the raw tile by four threads a token (B8's bonus); du from
//   the raw q and k before K̂ is written over k (one barrier more a tile);
//   the raw k (dq) and q (dk) of the bonus read back from global memory
//   in the epilogue, where L2 still holds the tile just loaded.
// - The exclusive backward at D <= 64 (RWKV-6's head dim; exclusive_dq_tc,
//   exclusive_dkv_tc): two rows a block, one a consumer warpgroup, each
//   on named barriers of its own, each row's loads issued by its own
//   thread 0 into a ring of three stages that both rows share; see the
//   comment above exclusive_dq_tc.
// - dg, fused: the dq launch also writes q⊙dq in fp32, as Q̂ ⊙ (dq e^{-b})
//   with Q̂ rounded to bf16 exactly as the dk/dv launch rounds it; the
//   dk/dv launch forms K̂ ⊙ (dk e^{b}) from the same bf16 K̂. Each pair of
//   tokens within a tile then enters q⊙dq and k⊙dk as the same product of
//   the same rounded numbers, and cancels in the difference as it does in
//   exact arithmetic (rounded separately, the in-tile pairs would leave
//   errors that the reverse cumulative sum adds up). Warpgroup 0 keeps
//   dk's part in shared memory; then a thread per channel and half tile
//   takes the reverse cumulative sum of the difference over the tile, adds
//   the later tiles' running sum it carries, applies the clamp's mask
//   (kept as bits from the decay scan) and writes dg in fp32. dq, dk and
//   dv are written in bf16 from the accumulators.
// - A barrier wait that lasts seconds traps, so that a lost phase fails
//   the launch instead of hanging the card.
//
// All launches run on the caller's stream and allocate nothing.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "../../csrc/hopper.cuh"

namespace {

// Tiling per head dim D (as B2/B3). Each product is an (M×N) tile over a
// thread grid MT×NT = kThreads; thread (ti, tj) holds rows ti + r·MT and
// columns tj + c·NT.
template <int D>
struct Cfg;

template <>
struct Cfg<128> {
  static constexpr int kThreads = 256;
  static constexpr int kTile = 32;   // TC: tokens per step, |b| <= 32
  static constexpr int kSlice = 64;  // DS: output / state columns per block
  static constexpr int kPm = 16, kPn = 16;  // scores  TC×TC
  static constexpr int kOm = 16, kOn = 16;  // output  TC×DS
  static constexpr int kSm = 32, kSn = 8;   // state   D×DS
};

// D = 96 and 64 (phi3-mini-3.8b; musicgen-large and RWKV-6): 32-column
// slices, three and two blocks per row
template <>
struct Cfg<96> {
  static constexpr int kThreads = 256;
  static constexpr int kTile = 32;   // |b| <= 32
  static constexpr int kSlice = 32;
  static constexpr int kPm = 16, kPn = 16;
  static constexpr int kOm = 16, kOn = 16;
  static constexpr int kSm = 32, kSn = 8;
};

template <>
struct Cfg<64> {
  static constexpr int kThreads = 256;
  static constexpr int kTile = 32;   // |b| <= 32
  static constexpr int kSlice = 32;
  static constexpr int kPm = 16, kPn = 16;
  static constexpr int kOm = 16, kOn = 16;
  static constexpr int kSm = 32, kSn = 8;
};

// D = 112 (zamba2-7b's shared attention): 16-column slices, seven blocks
// per row (112 is no multiple of 32)
template <>
struct Cfg<112> {
  static constexpr int kThreads = 256;
  static constexpr int kTile = 32;   // |b| <= 32
  static constexpr int kSlice = 16;
  static constexpr int kPm = 16, kPn = 16;
  static constexpr int kOm = 16, kOn = 16;
  static constexpr int kSm = 16, kSn = 16;
};

template <>
struct Cfg<16> {
  static constexpr int kThreads = 64;
  static constexpr int kTile = 16;
  static constexpr int kSlice = 16;
  static constexpr int kPm = 8, kPn = 8;
  static constexpr int kOm = 8, kOn = 8;
  static constexpr int kSm = 8, kSn = 8;
};

template <int D>
constexpr int smem_floats() {
  using C = Cfg<D>;
  return 3 * C::kTile * (D + 1)               // A, B tiles and b
         + C::kTile * (C::kSlice + 1)         // C slice
         + C::kTile * (C::kTile + 1)          // scores
         + D * (C::kSlice + 1)                // state slice
         + D + C::kTile;                      // exp(btot), diagonal bonus
}

// acc[r][c] += Σ_k A(ti + r·MT, k) · B(k, tj + c·NT) over k < K, with
// A(i, k) = A[i·ai + k·ak] and B(k, j) = B[k·bk + j·bj] in shared memory.
template <int RM, int RN, int MT, int NT, int K>
__device__ __forceinline__ void mma(float (&acc)[RM][RN], const float* A,
                                    int ai, int ak, const float* B, int bk,
                                    int bj, int ti, int tj) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[RM], b[RN];
#pragma unroll
    for (int r = 0; r < RM; ++r) a[r] = A[(ti + r * MT) * ai + k * ak];
#pragma unroll
    for (int c = 0; c < RN; ++c) b[c] = B[k * bk + (tj + c * NT) * bj];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < RN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

// What one sweep computes; see the header. The last three are the
// exclusive form's backward sweeps (strict mask, q scaled by e^{b_{t-1}},
// the bonus terms).
enum Mode : int {
  kFwd = 0,
  kFwdExclusive = 1,
  kDq = 2,
  kDk = 3,
  kDv = 4,
  kDqExclusive = 5,
  kDkExclusive = 6,
  kDvExclusive = 7
};

struct Sweep {
  const float* a;
  const float* b;
  const float* c;
  float* out;     // o, dq, dk or dv
  int mode;
};

__device__ __forceinline__ float clamp_decay(float g, float lo) {
  // jnp.clip's order: a NaN stays NaN
  return g < lo ? lo : (g > 0.f ? 0.f : g);
}

// b of the token before row r's (0 for the tile's first token), from the
// tile's cumulative log-decay Gs (rows reversed in a reverse sweep): the
// exclusive form's e^{b_{t-1}}
template <int TC, int LA, bool REVERSE>
__device__ __forceinline__ float prev_b_at(const float* Gs, int r, int col) {
  const int rp = REVERSE ? r + 1 : r - 1;
  return (REVERSE ? rp < TC : rp >= 0) ? Gs[rp * LA + col] : 0.f;
}

// grid (rows, D / DS, sweeps); block Cfg<D>::kThreads; dynamic shared
// memory smem_floats<D>() floats. blockIdx.z picks s0 or s1. g is the
// (rows, t, D) fp32 log-decay; u the (u_heads, D) bonus, row r reading
// u[r % u_heads] (exclusive modes only; rows are batch-major, heads
// minor).
// With EMIT_STATE (B8 only), state receives the final S (rows, D, D)
// fp32. The instantiations: <false, true> B8, <false, false> dq,
// <true, false> dk/dv.
template <int D, bool REVERSE, bool EMIT_STATE>
__global__ void __launch_bounds__(Cfg<D>::kThreads)
decay_sweep(Sweep s0, Sweep s1, const float* __restrict__ g,
            const float* __restrict__ u, int u_heads,
            float* __restrict__ state, int t_len, float min_log_decay) {
  using C = Cfg<D>;
  constexpr int kThreads = C::kThreads;
  constexpr int TC = C::kTile, DS = C::kSlice;
  constexpr int LA = D + 1, LC = DS + 1, LP = TC + 1;
  constexpr int kLanes = D % 32 ? 16 : 32;   // lanes that share a row
  static_assert(D % DS == 0 && TC % C::kPm == 0 && TC % C::kPn == 0 &&
                    TC % C::kOm == 0 && DS % C::kOn == 0 &&
                    D % C::kSm == 0 && DS % C::kSn == 0,
                "tiling does not divide");
  static_assert(C::kPm * C::kPn == kThreads && C::kOm * C::kOn == kThreads &&
                    C::kSm * C::kSn == kThreads,
                "thread grids must cover the block");
  static_assert(kThreads >= D && (TC * D) % kThreads == 0 &&
                    kThreads % 32 == 0 && D % kLanes == 0,
                "the cumulative sum and the bonus reduction need these");

  extern __shared__ float smem[];
  float* As = smem;
  float* Bs = As + TC * LA;
  float* Gs = Bs + TC * LA;    // b: cumulative log-decay from the tile start
  float* Cs = Gs + TC * LA;
  float* Ps = Cs + TC * LC;
  float* Ss = Ps + TC * LP;
  float* Et = Ss + D * LC;     // exp(btot) per channel
  float* Dg = Et + D;          // the diagonal per row: the bonus q·(u⊙k),
                               // or (dq, dk sweeps) do·v

  const Sweep sw = blockIdx.z ? s1 : s0;
  const int mode = sw.mode;
  const size_t row_off = static_cast<size_t>(blockIdx.x) * t_len * D;
  const float* __restrict__ A = sw.a + row_off;
  const float* __restrict__ B = sw.b + row_off;
  const float* __restrict__ Cg = sw.c + row_off;
  const float* __restrict__ G = g + row_off;
  const int col0 = blockIdx.y * DS;
  const int tid = threadIdx.x;
  // the decay index is the state's column (Dk-slice) for dq and dk, its
  // row (the full Dk) for o and dv
  const bool decay_cols = mode == kDq || mode == kDk ||
                          mode == kDqExclusive || mode == kDkExclusive;
  const bool strict = mode == kFwdExclusive || mode >= kDqExclusive;
  // the bonus sits on the scores' diagonal (o, dv), or the diagonal do·v
  // is kept for the bonus added to the output (dq, dk)
  const bool bonus_diag = mode == kFwdExclusive || mode == kDvExclusive;
  const bool keep_diag = mode == kDqExclusive || mode == kDkExclusive;
  const float* __restrict__ ur =
      strict ? u + static_cast<size_t>(blockIdx.x % u_heads) * D : nullptr;

  auto prev_b = [](const float* G, int r, int col) {
    return prev_b_at<TC, LA, REVERSE>(G, r, col);
  };

  for (int e = tid; e < D * LC; e += kThreads) Ss[e] = 0.f;

  const int n_tiles = (t_len + TC - 1) / TC;
  for (int step = 0; step < n_tiles; ++step) {
    const int tile = REVERSE ? n_tiles - 1 - step : step;
    const int tok0 = tile * TC;

    // -- the clamped log-decay (0 past the end), rows reversed in a
    //    reverse sweep --------------------------------------------------
    for (int e = tid; e < TC * D; e += kThreads) {
      const int r = e / D, col = e % D;
      const int tok = tok0 + (REVERSE ? TC - 1 - r : r);
      Gs[r * LA + col] =
          tok < t_len
              ? clamp_decay(G[static_cast<size_t>(tok) * D + col],
                            min_log_decay)
              : 0.f;
    }
    if (tid < TC) Dg[tid] = 0.f;
    __syncthreads();

    // -- b = inclusive cumulative sum in token order, per channel --------
    if (tid < D) {
      float acc = 0.f;
#pragma unroll 8
      for (int i = 0; i < TC; ++i) {
        const int r = REVERSE ? TC - 1 - i : i;
        acc += Gs[r * LA + tid];
        Gs[r * LA + tid] = acc;
      }
      Et[tid] = expf(acc);
    }
    __syncthreads();

    // -- load A, B (full width) and the C slice in fp32, scaled ----------
    for (int e = tid; e < TC * D; e += kThreads) {
      const int r = e / D, col = e % D;
      const int tok = tok0 + (REVERSE ? TC - 1 - r : r);
      float av = 0.f, bv = 0.f;
      if (tok < t_len) {
        const size_t off = static_cast<size_t>(tok) * D + col;
        av = A[off];
        bv = B[off];
      }
      const float b = Gs[r * LA + col];
      if (bonus_diag) {
        // the bonus q_t·(u⊙k_t) from the unscaled row, reduced over the
        // lanes that share the row (uniform branch: every lane is here)
        float p = av * ur[col] * bv;
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1)
          p += __shfl_xor_sync(0xffffffffu, p, off);
        if ((tid % kLanes) == 0) atomicAdd(&Dg[r], p);
      }
      if (mode == kFwd) {
        av *= expf(b);
        bv *= expf(-b);
      } else if (mode == kFwdExclusive) {
        av *= expf(prev_b(Gs, r, col));                     // e^{b_{t-1}}
        bv *= expf(-b);
      } else if (mode == kDv) {
        av *= expf(-b);
        bv *= expf(b);
      } else if (mode == kDvExclusive) {
        av *= expf(-b);
        bv *= expf(prev_b(Gs, r, col));
      }
      As[r * LA + col] = av;
      Bs[r * LA + col] = bv;
    }
    for (int e = tid; e < TC * DS; e += kThreads) {
      const int r = e / DS, col = e % DS;
      const int tok = tok0 + (REVERSE ? TC - 1 - r : r);
      float cv = tok < t_len
          ? Cg[static_cast<size_t>(tok) * D + col0 + col]
          : 0.f;
      if (mode == kDq || mode == kDqExclusive)
        cv *= expf(-Gs[r * LA + col0 + col]);
      if (mode == kDk) cv *= expf(Gs[r * LA + col0 + col]);
      if (mode == kDkExclusive) cv *= expf(prev_b(Gs, r, col0 + col));
      Cs[r * LC + col] = cv;
    }
    if (REVERSE) {   // R, decayed to the end of this tile -> to its start
      for (int e = tid; e < D * DS; e += kThreads) {
        const int i = e / DS, j = e % DS;
        Ss[i * LC + j] *= decay_cols ? Et[col0 + j] : Et[i];
      }
    }
    __syncthreads();

    // -- scores P = (A Bᵀ) ⊙ M (strict when exclusive: the bonus on the
    //    diagonal, or the diagonal kept aside) ------------------------------
    {
      constexpr int MT = C::kPm, NT = C::kPn, RM = TC / MT, RN = TC / NT;
      const int ti = tid / NT, tj = tid % NT;
      float acc[RM][RN] = {};
      mma<RM, RN, MT, NT, D>(acc, As, LA, 1, Bs, 1, LA, ti, tj);
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < RN; ++c) {
          const int i = ti + r * MT, j = tj + c * NT;
          float p = (j < i || (j == i && !strict)) ? acc[r][c] : 0.f;
          if (bonus_diag && j == i) p = Dg[i];
          if (keep_diag && j == i) Dg[i] = acc[r][c];
          Ps[i * LP + j] = p;
        }
    }
    __syncthreads();

    // -- out = (P C + A X) ⊙ E_out (X before this tile's update) ----------
    {
      constexpr int MT = C::kOm, NT = C::kOn, RM = TC / MT, RN = DS / NT;
      const int ti = tid / NT, tj = tid % NT;
      float acc[RM][RN] = {};
      mma<RM, RN, MT, NT, TC>(acc, Ps, LP, 1, Cs, LC, 1, ti, tj);
      mma<RM, RN, MT, NT, D>(acc, As, LA, 1, Ss, LC, 1, ti, tj);
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const int i = ti + r * MT;
        const int tok = tok0 + (REVERSE ? TC - 1 - i : i);
        if (tok < t_len) {
#pragma unroll
          for (int c = 0; c < RN; ++c) {
            const int col = col0 + tj + c * NT;
            const size_t off = static_cast<size_t>(tok) * D + col;
            const float scale =
                mode == kDq ? expf(Gs[i * LA + col])
                : mode == kDqExclusive ? expf(prev_b(Gs, i, col))
                : (mode == kDk || mode == kDkExclusive)
                    ? expf(-Gs[i * LA + col])
                    : 1.f;
            float y = acc[r][c] * scale;
            // the bonus: dq += (do·v) u⊙k, dk += (do·v) u⊙q, from the raw
            // k or q
            if (keep_diag) y += Dg[i] * ur[col] * Cg[off];
            sw.out[row_off + off] = y;
          }
        }
      }
    }
    __syncthreads();

    // -- X += Bᵀ C, then (forward) decayed over this tile ------------------
    {
      constexpr int MT = C::kSm, NT = C::kSn, RM = D / MT, RN = DS / NT;
      const int ti = tid / NT, tj = tid % NT;
      float acc[RM][RN];
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < RN; ++c)
          acc[r][c] = Ss[(ti + r * MT) * LC + tj + c * NT];
      mma<RM, RN, MT, NT, TC>(acc, Bs, 1, LA, Cs, LC, 1, ti, tj);
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < RN; ++c) {
          const int i = ti + r * MT, j = tj + c * NT;
          const float decay =
              REVERSE ? 1.f : (decay_cols ? Et[col0 + j] : Et[i]);
          Ss[i * LC + j] = acc[r][c] * decay;
        }
    }
    __syncthreads();
  }

  if (EMIT_STATE) {
    float* st = state + static_cast<size_t>(blockIdx.x) * D * D;
    for (int e = tid; e < D * DS; e += kThreads) {
      const int i = e / DS, j = e % DS;
      st[i * D + col0 + j] = Ss[i * LC + j];
    }
  }
}

template <int D, bool REVERSE, bool EMIT_STATE>
int launch(Sweep s0, Sweep s1, int n_sweeps, const float* g,
           const float* u, int u_heads, float* state, int rows, int t_len,
           float min_log_decay, cudaStream_t stream) {
  using C = Cfg<D>;
  constexpr size_t kSmem = smem_floats<D>() * sizeof(float);
  auto kernel = decay_sweep<D, REVERSE, EMIT_STATE>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(rows, D / C::kSlice, n_sweeps), block(C::kThreads);
  kernel<<<grid, block, kSmem, stream>>>(s0, s1, g, u, u_heads, state,
                                         t_len, min_log_decay);
  return static_cast<int>(cudaGetLastError());
}

template <bool REVERSE, bool EMIT_STATE>
int launch_d(Sweep s0, Sweep s1, int n_sweeps, const void* g,
             const void* u, int u_heads, void* state, int rows, int t_len,
             int d, float min_log_decay, void* stream) {
  const float* gf = static_cast<const float*>(g);
  const float* uf = static_cast<const float*>(u);
  float* sf = static_cast<float*>(state);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return launch<16, REVERSE, EMIT_STATE>(
          s0, s1, n_sweeps, gf, uf, u_heads, sf, rows, t_len,
          min_log_decay, st);
    case 64:
      return launch<64, REVERSE, EMIT_STATE>(
          s0, s1, n_sweeps, gf, uf, u_heads, sf, rows, t_len,
          min_log_decay, st);
    case 96:
      return launch<96, REVERSE, EMIT_STATE>(
          s0, s1, n_sweeps, gf, uf, u_heads, sf, rows, t_len,
          min_log_decay, st);
    case 112:
      return launch<112, REVERSE, EMIT_STATE>(
          s0, s1, n_sweeps, gf, uf, u_heads, sf, rows, t_len,
          min_log_decay, st);
    case 128:
      return launch<128, REVERSE, EMIT_STATE>(
          s0, s1, n_sweeps, gf, uf, u_heads, sf, rows, t_len,
          min_log_decay, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

Sweep sweep(const void* a, const void* b, const void* c, void* out,
            int mode) {
  return Sweep{static_cast<const float*>(a), static_cast<const float*>(b),
               static_cast<const float*>(c), static_cast<float*>(out), mode};
}

// ---------------------------------------------------------------------------
// B8 and B9 in bf16: tensor cores (see the header, body 2), on the TMA,
// mbarrier and wgmma helpers of kernels/csrc/hopper.cuh.
// ---------------------------------------------------------------------------
namespace tc {

constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, from a 1024-byte aligned base (the swizzle's period):
// two stages of {q, k, v, do: DC blocks of [64 tokens][64 bf16] each;
// g: GB blocks of [64 tokens][32 fp32]; with kSplit the low parts of Q̂
// and K̂}, every block as TMA writes it with the 128-byte swizzle; the
// state's bf16 copy (and with kSplit its low part), DC blocks of
// [DP rows][64 bf16], swizzled the same way; e^{btot} (log2 units) per
// channel; the scans' per-channel totals; the diagonal per token (B8's
// bonus, the exclusive backward's do·v and q·(u⊙k)); two mbarriers.
//
// kSplit (one 64-column block: D <= 64, the SSD's and RWKV-6's heads):
// every bf16 operand that carries a decay factor, Q̂ = q e^{b} and
// K̂ = k e^{-b}, and every score tile and state copy enters its products
// as two bf16 parts, hi = bf16(x) and lo = bf16(x − hi), so that the
// products carry about 16 bits where one part carries 8. The strong
// decays of those heads cancel: an output or a gradient of a token can
// be small beside the terms it sums, and a per-token normalisation
// after it (RWKV-6's groupnorm, Mamba-2's gated RMSNorm) or a reduction
// over tokens (a decay parameter's gradient) reads that token's
// relative error. The products cost two to four times the tensor-core
// work of one part, which the tile's bytes hide at these widths; the
// low parts' slots fit beside one block (D = 96 and up have no room).
template <int D>
struct L {
  static constexpr int DC = (D + 63) / 64;     // 64-column bf16 blocks
  static constexpr bool kSplit = DC == 1;
  static constexpr int DP = 64 * DC;           // D padded to them
  static constexpr int GB = (D + 31) / 32;     // 32-column fp32 blocks
  static constexpr int GW = 32 * GB;           // channels the scans take
  static constexpr int tile = DC * kBlock;     // one bf16 tensor's tile
  static constexpr int q = 0, k = tile, v = 2 * tile, o = 3 * tile,
                       g = 4 * tile;
  static constexpr int loaded = 4 * tile + GB * kBlock;   // TMA's bytes
  static constexpr int qlo = loaded, klo = loaded + tile;  // kSplit
  static constexpr int stage = loaded + (kSplit ? 2 * tile : 0);
  static constexpr int x = 2 * stage;
  static constexpr int xblock = DP * kRowBytes;
  static constexpr int xlo = x + DC * xblock;              // kSplit
  static constexpr int btot = xlo + (kSplit ? DC * xblock : 0);
  static constexpr int tot = btot + 4 * DP;
  static constexpr int bonus = tot + 8 * GW;
  static constexpr int bars = bonus + 4 * kTile;
  static constexpr int bytes = bars + 16 + 1024;
};

// byte offset of fp32 element (r, c) in a swizzled g tile
__device__ __forceinline__ int off32(int r, int c) {
  return (c >> 5) * kBlock + r * kRowBytes +
         ((((c & 31) >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2);
}

// 2^x in one MUFU op
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a bf16 pair scaled by 2^(b0), 2^(b1), rounded to bf16: the one
// definition of Q̂ and K̂, so that both launches round them alike
__device__ __forceinline__ uint32_t scale_pair(uint32_t x, float b0,
                                               float b1) {
  return pack_bf16(lo_f(x) * ex2(b0), hi_f(x) * ex2(b1));
}

__device__ __forceinline__ float clamp_decay(float g, float lo) {
  return g < lo ? lo : (g > 0.f ? 0.f : g);  // jnp.clip's order: NaN stays
}

// A barrier over the block (WG false) or over one warpgroup's 128 threads
// (WG: the named barrier `id`, which no other warpgroup uses)
template <bool WG>
__device__ __forceinline__ void sync_threads(int id) {
  if constexpr (WG)
    asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
  else
    __syncthreads();
}

// one arrival on an mbarrier (the release of a stage)
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// The tile's cumulative clamped log-decay b (inclusive, from the tile's
// first token, per channel), written over g in log2 units, and
// btot[c] = b of the last token. Thread (c, h) = (tid % GW, tid / GW)
// takes tokens 32h..32h+31 of channel c (threads past 2·GW only meet the
// barriers) and returns the clamp's mask for them: bit i is set where
// min_log_decay <= g <= 0 at token 32h + i. Ends with the block (WG: the
// warpgroup, tid its index in it, on named barrier bar) in step.
template <int D, bool WG = false>
__device__ __forceinline__ uint32_t decay_scan(uint8_t* gs, float* tot,
                                               float* btot, float lo,
                                               int tid, int bar = 0) {
  using S = L<D>;
  const int c = tid % S::GW, h = tid / S::GW;
  const bool on = tid < 2 * S::GW;
  uint32_t mask = 0;
  float loc[32];
  if (on) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float x = *reinterpret_cast<const float*>(gs + off32(32 * h + i,
                                                                 c));
      mask |= static_cast<uint32_t>(x >= lo && x <= 0.f) << i;
      acc += clamp_decay(x, lo);
      loc[i] = acc;
    }
    if (h == 0) tot[c] = acc;
  }
  sync_threads<WG>(bar);
  if (on) {
    const float off = h ? tot[c] : 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      *reinterpret_cast<float*>(gs + off32(32 * h + i, c)) =
          (loc[i] + off) * kLog2e;
    if (h) btot[c] = (loc[31] + off) * kLog2e;
  }
  sync_threads<WG>(bar);
  return mask;
}

// x ← bf16(x · 2^(sign · b)) in place over a tile slot's real columns;
// PREV takes b of the token before (0 for the tile's first): the exclusive
// form's e^{b_{t-1}}
template <int D, bool PREV = false>
__device__ __forceinline__ void scale_slot(uint8_t* slot, const uint8_t* gs,
                                           float sign, int tid) {
  using S = L<D>;
  for (int e = tid; e < S::DC * 64 * 8; e += kThreads) {
    const int blk = e >> 9, r = (e >> 3) & 63, ch = e & 7;
    const int c0 = blk * 64 + ch * 8;
    if (c0 >= D) continue;
    uint4* p = reinterpret_cast<uint4*>(slot + blk * kBlock + r * kRowBytes +
                                        ((ch ^ (r & 7)) << 4));
    float4 b0 = make_float4(0.f, 0.f, 0.f, 0.f), b1 = b0;
    if (!PREV || r > 0) {
      const int rb = PREV ? r - 1 : r;
      b0 = *reinterpret_cast<const float4*>(gs + off32(rb, c0));
      b1 = *reinterpret_cast<const float4*>(gs + off32(rb, c0 + 4));
    }
    uint4 x = *p;
    x.x = scale_pair(x.x, sign * b0.x, sign * b0.y);
    x.y = scale_pair(x.y, sign * b0.z, sign * b0.w);
    x.z = scale_pair(x.z, sign * b1.x, sign * b1.y);
    x.w = scale_pair(x.w, sign * b1.z, sign * b1.w);
    *p = x;
  }
}

// x ← x · 2^(sign · b) over a tile slot's real columns in two bf16
// parts: hi = bf16(x · 2^(sign·b)) over the slot, lo = bf16(that − hi)
// into `lo_slot` (its columns past D zeroed); PREV takes b of the token
// before (0 for the tile's first). The products that read hi and lo
// carry the scaled operand to about 16 bits (B8's state update, and
// every product of a kSplit tile). Both launches of B9 split Q̂ and K̂
// with these same operations. NT threads share the work.
template <int D, bool PREV = false, int NT = kThreads>
__device__ __forceinline__ void split_slot(uint8_t* slot, uint8_t* lo_slot,
                                           const uint8_t* gs, float sign,
                                           int tid) {
  using S = L<D>;
  for (int e = tid; e < S::DC * 64 * 8; e += NT) {
    const int blk = e >> 9, r = (e >> 3) & 63, ch = e & 7;
    const int c0 = blk * 64 + ch * 8;
    const int at = blk * kBlock + r * kRowBytes + ((ch ^ (r & 7)) << 4);
    uint4* p = reinterpret_cast<uint4*>(slot + at);
    uint4* q = reinterpret_cast<uint4*>(lo_slot + at);
    if (c0 >= D) {
      *q = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    float4 b0 = make_float4(0.f, 0.f, 0.f, 0.f), b1 = b0;
    if (!PREV || r > 0) {
      const int rb = PREV ? r - 1 : r;
      b0 = *reinterpret_cast<const float4*>(gs + off32(rb, c0));
      b1 = *reinterpret_cast<const float4*>(gs + off32(rb, c0 + 4));
    }
    const uint4 x = *p;
    const float y[8] = {lo_f(x.x) * ex2(sign * b0.x),
                        hi_f(x.x) * ex2(sign * b0.y),
                        lo_f(x.y) * ex2(sign * b0.z),
                        hi_f(x.y) * ex2(sign * b0.w),
                        lo_f(x.z) * ex2(sign * b1.x),
                        hi_f(x.z) * ex2(sign * b1.y),
                        lo_f(x.w) * ex2(sign * b1.z),
                        hi_f(x.w) * ex2(sign * b1.w)};
    uint32_t h[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i] = pack_bf16(y[2 * i], y[2 * i + 1]);
      l[i] = pack_bf16(y[2 * i] - lo_f(h[i]), y[2 * i + 1] - hi_f(h[i]));
    }
    *p = make_uint4(h[0], h[1], h[2], h[3]);
    *q = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// The bf16 copy of a 64-column state in two parts, hi into xs and lo into
// xlo (one 64-row block each), from its rows r0 and r0 + 8 in the
// accumulator layout
__device__ __forceinline__ void store_state_split(uint8_t* xs, uint8_t* xlo,
                                                  const float (&x)[32],
                                                  int r0, int cl) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const int at = off16(kBlock, r0 + 8 * h, 8 * g + cl);
      const float a = x[4 * g + 2 * h], b = x[4 * g + 2 * h + 1];
      const uint32_t hi = pack_bf16(a, b);
      *reinterpret_cast<uint32_t*>(xs + at) = hi;
      *reinterpret_cast<uint32_t*>(xlo + at) =
          pack_bf16(a - lo_f(hi), b - hi_f(hi));
    }
}

// The bf16 copy of a warpgroup's state rows, as hopper.cuh's store_state,
// and with kSplit its low part into the copy's second region
template <int D>
__device__ __forceinline__ void store_state_parts(
    uint8_t* sb, const float (&x)[L<D>::DC][32], int wg, int r0, int cl) {
  using S = L<D>;
  if constexpr (!S::kSplit)
    store_state(sb + S::x, S::xblock, x, wg, r0, cl);
  else   // one block: wg is 0
    store_state_split(sb + S::x, sb + S::xlo, x[0], 64 * wg + r0, cl);
}

// the fp32 value of a split pair, hi + lo, as the products see it
__device__ __forceinline__ float2 split_value(uint32_t hi, uint32_t lo) {
  return make_float2(lo_f(hi) + lo_f(lo), hi_f(hi) + hi_f(lo));
}

// multiplies this warpgroup's state rows by 2^btot[row]
template <int D>
__device__ __forceinline__ void decay_state(float (&x)[L<D>::DC][32],
                                            const float* btot, int wg,
                                            int r0) {
  const float e0 = ex2(btot[64 * wg + r0]), e1 = ex2(btot[64 * wg + r0 + 8]);
#pragma unroll
  for (int j = 0; j < L<D>::DC; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) x[j][i] *= (i & 2) ? e1 : e0;
}

// The loads of one tile (its first token tok0) into a stage: q, k, v and
// (DO: B9) do in 64-column blocks, g in 32-column blocks; rows past T read
// as zeros
template <int D, bool DO = true>
__device__ __forceinline__ void load_tile(
    uint32_t stage, uint32_t bar, const CUtensorMap* tq,
    const CUtensorMap* tk, const CUtensorMap* tv, const CUtensorMap* to,
    const CUtensorMap* tg, int tok0, int row) {
  using S = L<D>;
  mbar_expect_tx(bar, DO ? S::loaded : S::loaded - S::tile);
#pragma unroll
  for (int cb = 0; cb < S::DC; ++cb) {
    tma_load(stage + S::q + cb * kBlock, tq, bar, 64 * cb, tok0, row);
    tma_load(stage + S::k + cb * kBlock, tk, bar, 64 * cb, tok0, row);
    tma_load(stage + S::v + cb * kBlock, tv, bar, 64 * cb, tok0, row);
    if (DO) tma_load(stage + S::o + cb * kBlock, to, bar, 64 * cb, tok0, row);
  }
#pragma unroll
  for (int gb = 0; gb < S::GB; ++gb)
    tma_load(stage + S::g + gb * kBlock, tg, bar, 32 * gb, tok0, row);
}

// Σ_c a(r, c)·w_c·b(r, c) of each of the tile's 64 tokens from two raw
// bf16 slots (w_c = 1 without w), four threads a token: the exclusive
// form's q·(u⊙k) and do·v. Token r = t / 4 is returned to all four.
template <int D>
__device__ __forceinline__ float token_dot(const uint8_t* a,
                                           const uint8_t* b, const float* w,
                                           int t) {
  const int r = t / 4, part = t % 4;
  float p = 0.f;
#pragma unroll
  for (int c = 2 * part; c < D; c += 8) {
    const uint32_t x = *reinterpret_cast<const uint32_t*>(
        a + off16(kBlock, r, c));
    const uint32_t y = *reinterpret_cast<const uint32_t*>(
        b + off16(kBlock, r, c));
    const float w0 = w ? __ldg(w + c) : 1.f, w1 = w ? __ldg(w + c + 1) : 1.f;
    p += lo_f(x) * w0 * lo_f(y) + hi_f(x) * w1 * hi_f(y);
  }
  p += __shfl_xor_sync(0xffffffffu, p, 1);
  p += __shfl_xor_sync(0xffffffffu, p, 2);
  return p;
}

// The exclusive backward's score tiles: mask_split's two bf16 parts over
// the strict triangle (column < row, LOWER; or column > row), with
// diag(r, h) on the diagonal of row r = r0 + 8h
template <bool LOWER, typename Diag>
__device__ __forceinline__ void mask_split_strict_by(const float (&s)[32],
                                                     uint32_t (&hi)[4][4],
                                                     uint32_t (&lo)[4][4],
                                                     int r0, int cl,
                                                     Diag diag) {
#pragma unroll
  for (int x = 0; x < 32; x += 2) {
    const int r = r0 + 8 * ((x >> 1) & 1), c = 8 * (x >> 2) + cl;
    const float d = diag(r, (x >> 1) & 1);
    const float a = (LOWER ? c < r : c > r) ? s[x] : (c == r ? d : 0.f);
    const float b =
        (LOWER ? c + 1 < r : c + 1 > r) ? s[x + 1] : (c + 1 == r ? d : 0.f);
    const uint32_t h = pack_bf16(a, b);
    hi[x / 8][(x % 8) / 2] = h;
    lo[x / 8][(x % 8) / 2] = pack_bf16(a - lo_f(h), b - hi_f(h));
  }
}

// mask_split_strict_by with diag[r] on the diagonal, or 0 where diag is
// null
template <bool LOWER>
__device__ __forceinline__ void mask_split_strict(const float (&s)[32],
                                                  uint32_t (&hi)[4][4],
                                                  uint32_t (&lo)[4][4],
                                                  int r0, int cl,
                                                  const float* diag) {
  mask_split_strict_by<LOWER>(s, hi, lo, r0, cl, [diag](int r, int) {
    return diag ? diag[r] : 0.f;
  });
}

// B9's forward sweep: per 64-token tile, with b from the tile's start and
// S[dk][dv] the state at the tile's start,
//     acc = (dO Vᵀ ⊙ M) K̂ + dO Sᵀ ;  dq = e^{b} ⊙ acc ;  q⊙dq = Q̂ ⊙ acc
//     S ← e^{btot} ⊙ (S + K̂ᵀ V)           (rows, per dk)
// EXCLUSIVE (the exclusive form with the bonus u, RWKV-6): M strict and
// Q̂ = q e^{b_{t-1}}, so dq = e^{b_{t-1}} ⊙ acc + (do·v) u⊙k and q⊙dq =
// Q̂ ⊙ acc, the decay's share alone (the bonus's does not enter dg); and
// du_rows[row] = Σ_t (do_t·v_t) q_t⊙k_t in fp32, from the raw tile (k
// before it is scaled: one more barrier a tile), k_raw read back for the
// bonus from global memory (the tile's k, just loaded, in L2).
// grid (rows); block kThreads; dynamic shared memory L<D>::bytes. Tensor
// maps (D, T, rows) with boxes (64, 64, 1) for q, k, v, do and (32, 64, 1)
// for g.
template <int D, bool EXCLUSIVE>
__global__ void __launch_bounds__(kThreads, 1)
decay_sweep_dq_tc(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap to,
                  const __grid_constant__ CUtensorMap tg,
                  __nv_bfloat16* __restrict__ dq, float* __restrict__ qdq,
                  const __nv_bfloat16* __restrict__ k_raw,
                  const float* __restrict__ u, int u_heads,
                  float* __restrict__ du, int t_len, float lo) {
  using S = L<D>;
  constexpr int DC = S::DC;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sb = smem_raw + (base - raw);
  float* const btot = reinterpret_cast<float*>(sb + S::btot);
  float* const tot = reinterpret_cast<float*>(sb + S::tot);
  float* const dov = reinterpret_cast<float*>(sb + S::bonus);
  const uint32_t bar0 = base + S::bars;
  // the warpgroup, from lane 0: provably uniform, so that ptxas does not
  // take the wgmma branches on it for divergent paths
  const int tid = threadIdx.x,
            wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int row = blockIdx.x;
  const int n_tiles = (t_len + kTile - 1) / kTile;

  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int c = tid; c < S::DP; c += kThreads) btot[c] = 0.f;
  __syncthreads();
  if (tid == 0)
    load_tile<D>(base, bar0, &tq, &tk, &tv, &to, &tg, 0, row);

  float x[DC][32];   // S rows 64·wg + (0..63) (wg < DC)
#pragma unroll
  for (int j = 0; j < DC; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) x[j][i] = 0.f;
  float du_acc = 0.f;   // EXCLUSIVE: du of channel tid % GW, half tid / GW

  for (int it = 0; it < n_tiles; ++it) {
    // Offsets derived from the thread index are recomputed in each tile:
    // hoisted out of the loop, they would hold dozens of registers.
    int t = threadIdx.x;
    asm volatile("" : "+r"(t));
    const int r0 = (t % 128) / 32 * 16 + (t % 32) / 4, cl = 2 * (t % 4);
    if (tid == 0 && it + 1 < n_tiles)
      load_tile<D>(base + ((it + 1) & 1) * S::stage, bar0 + 8 * ((it + 1) & 1),
                   &tq, &tk, &tv, &to, &tg, (it + 1) * kTile, row);
    const uint32_t st = base + (it & 1) * S::stage;
    uint8_t* const ss = sb + (it & 1) * S::stage;
    const int tok0 = it * kTile;
    mbar_wait(bar0 + 8 * (it & 1), (it >> 1) & 1);

    if constexpr (EXCLUSIVE) {   // do·v, read after decay_scan's barrier
      const float p = token_dot<D>(ss + S::o, ss + S::v, nullptr, t);
      if (t % 4 == 0) dov[t / 4] = p;
    }
    decay_scan<D>(ss + S::g, tot, btot, lo, t);
    if constexpr (EXCLUSIVE) {
      // du: Σ (do·v) q⊙k over this thread's 32 tokens of its channel, from
      // the raw q and k, before K̂ is written over k
      const int c = t % S::GW, h = t / S::GW;
      if (t < 2 * S::GW && c < D) {
#pragma unroll 8
        for (int i = 0; i < 32; ++i) {
          const int r = 32 * h + i;
          du_acc += dov[r] *
                    __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                        ss + S::q + off16(kBlock, r, c))) *
                    __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                        ss + S::k + off16(kBlock, r, c)));
        }
      }
      __syncthreads();
    }
    if (wg < DC) store_state_parts<D>(sb, x, wg, r0, cl);
    if constexpr (S::kSplit)                                      // K̂
      split_slot<D>(ss + S::k, ss + S::klo, ss + S::g, -1.f, t);
    else
      scale_slot<D>(ss + S::k, ss + S::g, -1.f, t);
    fence_async();
    __syncthreads();

    if (wg < DC) {
      float sc[32], acc[32];
      uint32_t hi[4][4], lo2[4][4];
      // the score tile dO Vᵀ, alone: no register of a later product is
      // written while a wgmma group is open (ptxas would serialize them)
      fence_regs(sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * DC; ++kk)
        wgmma_ss<0, 0>(sc, kdesc(st + S::o, kBlock, kk),
                       kdesc(st + S::v, kBlock, kk), kk > 0);
      wg_commit();
      fence_regs(sc);
      wg_wait<0>();
      fence_regs(sc);
      if constexpr (EXCLUSIVE)
        mask_split_strict<true>(sc, hi, lo2, r0, cl, nullptr);
      else
        mask_split<true>(sc, hi, lo2, r0, cl);
      // acc = P K̂ (this warpgroup's 64 columns) + dO Sᵀ; beside it the
      // state update S += K̂ᵀ V (S's copy in shared memory is read, the
      // registers are updated)
      fence_regs(acc);
      fence_regs(x);
      fence_regs(hi);
      fence_regs(lo2);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc, hi[kk], mdesc(st + S::k + wg * kBlock, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc, lo2[kk], mdesc(st + S::k + wg * kBlock, kk), 1);
      if constexpr (S::kSplit) {   // P K̂lo, dO S_loᵀ, S += K̂loᵀ V
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(acc, hi[kk], mdesc(st + S::klo, kk), 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(acc, lo2[kk], mdesc(st + S::klo, kk), 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<0, 0>(acc, kdesc(st + S::o, kBlock, kk),
                         kdesc(base + S::xlo, S::xblock, kk), 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<1, 1>(x[0], mdesc(st + S::klo, kk),
                         mdesc(st + S::v, kk), 1);
      }
#pragma unroll
      for (int kk = 0; kk < 4 * DC; ++kk)
        wgmma_ss<0, 0>(acc, kdesc(st + S::o, kBlock, kk),
                       kdesc(base + S::x + 64 * wg * kRowBytes, S::xblock,
                             kk),
                       1);
#pragma unroll
      for (int j = 0; j < DC; ++j)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<1, 1>(x[j], mdesc(st + S::k + wg * kBlock, kk),
                         mdesc(st + S::v + j * kBlock, kk), 1);
      wg_commit();
      fence_regs(acc);
      fence_regs(x);
      fence_regs(hi);
      fence_regs(lo2);
      wg_wait<0>();
      fence_regs(acc);
      fence_regs(x);

      // dq = e^{b} acc in bf16; q⊙dq = Q̂ acc in fp32 (EXCLUSIVE: b of
      // the token before, and dq's bonus (do·v) u⊙k)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h, tok = tok0 + r;
        if (tok >= t_len) continue;
        const size_t off = (static_cast<size_t>(row) * t_len + tok) * D;
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const int c = 64 * wg + 8 * g + cl;
          if (c >= D) continue;
          float2 b = make_float2(0.f, 0.f);
          if (!EXCLUSIVE || r > 0)
            b = *reinterpret_cast<const float2*>(
                ss + S::g + off32(EXCLUSIVE ? r - 1 : r, c));
          const float a0 = acc[4 * g + 2 * h], a1 = acc[4 * g + 2 * h + 1];
          float y0 = a0 * ex2(b.x), y1 = a1 * ex2(b.y);
          if constexpr (EXCLUSIVE) {
            const float d = dov[r];
            const uint32_t kr = __ldg(
                reinterpret_cast<const unsigned int*>(k_raw + off + c));
            const float2 uu = __ldg(reinterpret_cast<const float2*>(
                u + static_cast<size_t>(row % u_heads) * D + c));
            y0 += d * uu.x * lo_f(kr);
            y1 += d * uu.y * hi_f(kr);
          }
          *reinterpret_cast<uint32_t*>(dq + off + c) = pack_bf16(y0, y1);
          // Q̂ as the dk/dv launch rounds it (kSplit: its hi + lo)
          const uint32_t qr = *reinterpret_cast<const uint32_t*>(
              ss + S::q + off16(kBlock, r, c));
          float2 qm;
          if constexpr (S::kSplit) {
            const float q0 = lo_f(qr) * ex2(b.x), q1 = hi_f(qr) * ex2(b.y);
            const uint32_t qh = pack_bf16(q0, q1);
            qm = split_value(qh, pack_bf16(q0 - lo_f(qh), q1 - hi_f(qh)));
          } else {
            const uint32_t qh = scale_pair(qr, b.x, b.y);
            qm = make_float2(lo_f(qh), hi_f(qh));
          }
          *reinterpret_cast<float2*>(qdq + off + c) =
              make_float2(qm.x * a0, qm.y * a1);
        }
      }
      decay_state<D>(x, btot, wg, r0);
    }
    fence_async();
    __syncthreads();   // the stage and the state copy are free
  }

  if constexpr (EXCLUSIVE) {   // du_rows: the two halves' sums, in order
    const int c = tid % S::GW, h = tid / S::GW;
    const bool on = tid < 2 * S::GW && c < D;
    if (on && h == 1) tot[c] = du_acc;
    __syncthreads();
    if (on && h == 0) du[static_cast<size_t>(row) * D + c] = du_acc + tot[c];
  }
}

// sc = A Bᵀ of two K-major tiles at a and b, and with EXTRA the low
// parts' A B_loᵀ + A_lo Bᵀ: one wgmma group, alone, waited for (no
// register of a later product is written while it is open)
template <int D, bool EXTRA>
__device__ __forceinline__ void score_tile(float (&sc)[32], uint32_t a,
                                           uint32_t b, uint32_t a_lo,
                                           uint32_t b_lo) {
  fence_regs(sc);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4 * L<D>::DC; ++kk)
    wgmma_ss<0, 0>(sc, kdesc(a, kBlock, kk), kdesc(b, kBlock, kk), kk > 0);
  if constexpr (EXTRA) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<0, 0>(sc, kdesc(a, kBlock, kk), kdesc(b_lo, kBlock, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<0, 0>(sc, kdesc(a_lo, kBlock, kk), kdesc(b, kBlock, kk), 1);
  }
  wg_commit();
  fence_regs(sc);
  wg_wait<0>();
  fence_regs(sc);
}

// The dk/dv launch's products for warpgroup WG, straight-line (a branch
// inside an open wgmma group makes ptxas serialize it): per 64 columns j,
// acc_k = S1 Q̂ + V Xᵀ (WG 0) or dv = S2 dO + K̂ X (WG 1), S1 or S2 as the
// hi and lo parts; beside them the update X += Q̂ᵀ dO of its state rows.
// kSplit: Q̂, K̂ and X's copy in two parts as well.
template <int D, int WG>
__device__ __forceinline__ void dkv_products(float (&acc)[L<D>::DC][32],
                                             float (&x)[L<D>::DC][32],
                                             uint32_t (&hi)[4][4],
                                             uint32_t (&lo)[4][4],
                                             uint32_t st, uint32_t base) {
  using S = L<D>;
  constexpr int DC = S::DC;
  const uint32_t rb = st + (WG ? S::o : S::q);
  fence_regs(acc);
  fence_regs(x);
  fence_regs(hi);
  fence_regs(lo);
  wg_fence();
#pragma unroll
  for (int j = 0; j < DC; ++j) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc[j], hi[kk], mdesc(rb + j * kBlock, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc[j], lo[kk], mdesc(rb + j * kBlock, kk), 1);
    if constexpr (S::kSplit && WG == 0) {   // S1 Q̂lo, V X_loᵀ
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc[0], hi[kk], mdesc(st + S::qlo, kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc[0], lo[kk], mdesc(st + S::qlo, kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<0, 0>(acc[0], kdesc(st + S::v, kBlock, kk),
                       kdesc(base + S::xlo, S::xblock, kk), 1);
    }
    if constexpr (S::kSplit && WG == 1) {   // K̂ X_lo, K̂lo X
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<0, 1>(acc[0], kdesc(st + S::k, kBlock, kk),
                       mdesc(base + S::xlo, kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<0, 1>(acc[0], kdesc(st + S::klo, kBlock, kk),
                       mdesc(base + S::x, kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < 4 * DC; ++kk) {
      if constexpr (WG == 0)
        wgmma_ss<0, 0>(acc[j], kdesc(st + S::v, kBlock, kk),
                       kdesc(base + S::x + 64 * j * kRowBytes, S::xblock,
                             kk),
                       1);
      else
        wgmma_ss<0, 1>(acc[j], kdesc(st + S::k, kBlock, kk),
                       mdesc(base + S::x + j * S::xblock, kk), 1);
    }
  }
  if constexpr (WG < DC) {
#pragma unroll
    for (int j = 0; j < DC; ++j)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<1, 1>(x[j], mdesc(st + S::q + WG * kBlock, kk),
                       mdesc(st + S::o + j * kBlock, kk), 1);
    if constexpr (S::kSplit) {   // X += Q̂loᵀ dO
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<1, 1>(x[0], mdesc(st + S::qlo, kk), mdesc(st + S::o, kk),
                       1);
    }
  }
  wg_commit();
  fence_regs(acc);
  fence_regs(x);
  fence_regs(hi);
  fence_regs(lo);
  wg_wait<0>();
  fence_regs(acc);
  fence_regs(x);
}

// B9's reverse sweep, tiles last to first: per tile, with X = R decayed
// to the tile's start (X ← e^{btot} ⊙ X first, rows per dk),
//     acc_k = (V dOᵀ ⊙ Mᵀ) Q̂ + V Xᵀ ;  dk = e^{-b} ⊙ acc_k
//     dv = (K̂ Q̂ᵀ ⊙ Mᵀ) dO + K̂ X ;      X += Q̂ᵀ dO
//     dg = reverse-cumsum over T of (q⊙dq − K̂ ⊙ acc_k), masked
// with q⊙dq from the dq launch. EXCLUSIVE (the exclusive form with u):
// Mᵀ strict, Q̂ = q e^{b_{t-1}} in the scores and in X's update, dv's
// score tile with q·(u⊙k) on its diagonal, dk += (do·v) u⊙q (q_raw read
// back from global memory), and dg_t = Σ_{s>t} q⊙dq − Σ_{s≥t} k⊙dk: the
// query at s decays by b_{s−1}, so its reverse sum starts a token later.
// Launch as decay_sweep_dq_tc.
template <int D, bool EXCLUSIVE>
__global__ void __launch_bounds__(kThreads, 1)
decay_sweep_dkv_tc(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap to,
                   const __grid_constant__ CUtensorMap tg,
                   const float* __restrict__ qdq,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, float* __restrict__ dg,
                   const __nv_bfloat16* __restrict__ q_raw,
                   const float* __restrict__ u, int u_heads, int t_len,
                   float lo) {
  using S = L<D>;
  constexpr int DC = S::DC;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sb = smem_raw + (base - raw);
  float* const btot = reinterpret_cast<float*>(sb + S::btot);
  float* const tot = reinterpret_cast<float*>(sb + S::tot);
  float* const bonus = reinterpret_cast<float*>(sb + S::bonus);
  const float* const ur =
      EXCLUSIVE ? u + static_cast<size_t>(blockIdx.x % u_heads) * D
                : nullptr;
  const uint32_t bar0 = base + S::bars;
  // the warpgroup, from lane 0: provably uniform, so that ptxas does not
  // take the wgmma branches on it for divergent paths
  const int tid = threadIdx.x,
            wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int row = blockIdx.x;
  const int n_tiles = (t_len + kTile - 1) / kTile;

  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int c = tid; c < S::DP; c += kThreads) btot[c] = 0.f;
  __syncthreads();
  if (tid == 0)
    load_tile<D>(base, bar0, &tq, &tk, &tv, &to, &tg,
                 (n_tiles - 1) * kTile, row);

  float x[DC][32];   // R rows 64·wg + (0..63) (wg < DC)
#pragma unroll
  for (int j = 0; j < DC; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) x[j][i] = 0.f;
  float carry = 0.f;   // dg: the later tiles' sum, channel sc_c

  for (int it = 0; it < n_tiles; ++it) {
    // Offsets derived from the thread index are recomputed in each tile:
    // hoisted out of the loop, they would hold dozens of registers.
    int t = threadIdx.x;
    asm volatile("" : "+r"(t));
    const int r0 = (t % 128) / 32 * 16 + (t % 32) / 4, cl = 2 * (t % 4);
    // the dg scan's thread: channel c, tokens 32h..32h+31 of the tile
    const int sc_c = t % S::GW, sc_h = t / S::GW;
    const bool scans = t < 2 * S::GW && sc_c < D;
    if (tid == 0 && it + 1 < n_tiles)
      load_tile<D>(base + ((it + 1) & 1) * S::stage, bar0 + 8 * ((it + 1) & 1),
                   &tq, &tk, &tv, &to, &tg, (n_tiles - 2 - it) * kTile, row);
    const uint32_t st = base + (it & 1) * S::stage;
    uint8_t* const ss = sb + (it & 1) * S::stage;
    const int tok0 = (n_tiles - 1 - it) * kTile;
    mbar_wait(bar0 + 8 * (it & 1), (it >> 1) & 1);

    if constexpr (EXCLUSIVE) {   // q·(u⊙k) from the raw tile, as B8's
      const float p = token_dot<D>(ss + S::q, ss + S::k, ur, t);
      if (t % 4 == 0) bonus[t / 4] = p;
    }
    const uint32_t mask = decay_scan<D>(ss + S::g, tot, btot, lo, t);
    if constexpr (EXCLUSIVE) {   // do·v, into tot (free until the dg scan)
      const float p = token_dot<D>(ss + S::o, ss + S::v, nullptr, t);
      if (t % 4 == 0) tot[t / 4] = p;
    }
    if (wg < DC) {
      decay_state<D>(x, btot, wg, r0);
      store_state_parts<D>(sb, x, wg, r0, cl);
    }
    if constexpr (S::kSplit) {                                     // Q̂, K̂
      split_slot<D, EXCLUSIVE>(ss + S::q, ss + S::qlo, ss + S::g, 1.f, t);
      split_slot<D>(ss + S::k, ss + S::klo, ss + S::g, -1.f, t);
    } else {
      scale_slot<D, EXCLUSIVE>(ss + S::q, ss + S::g, 1.f, t);
      scale_slot<D>(ss + S::k, ss + S::g, -1.f, t);
    }
    fence_async();
    __syncthreads();

    float acc[DC][32];
    {
      float sc[32];
      uint32_t hi[4][4], lo2[4][4];
      // this warpgroup's score tile, alone (as in the dq launch): V dOᵀ
      // for dk, K̂ Q̂ᵀ for dv (kSplit: its two parts' three products)
      if (wg == 0)
        score_tile<D, false>(sc, st + S::v, st + S::o, 0, 0);
      else
        score_tile<D, S::kSplit>(sc, st + S::k, st + S::q, st + S::klo,
                                 st + S::qlo);
      if constexpr (EXCLUSIVE)
        mask_split_strict<false>(sc, hi, lo2, r0, cl, wg ? bonus : nullptr);
      else
        mask_split<false>(sc, hi, lo2, r0, cl);

      if (wg == 0)
        dkv_products<D, 0>(acc, x, hi, lo2, st, base);
      else
        dkv_products<D, 1>(acc, x, hi, lo2, st, base);
    }

    // this tile's q⊙dq for the dg scan, in flight during the epilogue;
    // EXCLUSIVE (D = 96 to 128 here) loads it after the epilogue, whose
    // bonus reads beside these 32 registers spilled
    float pv[32];
    const auto load_pv = [&] {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int tok = tok0 + 32 * sc_h + i;
        pv[i] = scans && tok < t_len
                    ? __ldg(qdq +
                            (static_cast<size_t>(row) * t_len + tok) * D +
                            sc_c)
                    : 0.f;
      }
    };
    if constexpr (!EXCLUSIVE) load_pv();

    // dk = e^{-b} acc_k and K̂ ⊙ acc_k (over b, in place); dv
#pragma unroll
    for (int j = 0; j < DC; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h, tok = tok0 + r;
        const size_t off = (static_cast<size_t>(row) * t_len + tok) * D;
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const int c = 64 * j + 8 * g + cl;
          if (c >= D) continue;
          const float a0 = acc[j][4 * g + 2 * h];
          const float a1 = acc[j][4 * g + 2 * h + 1];
          if (wg == 0) {
            float2* bp = reinterpret_cast<float2*>(ss + S::g + off32(r, c));
            const float2 b = *bp;
            const uint32_t kh = *reinterpret_cast<const uint32_t*>(
                ss + S::k + off16(kBlock, r, c));
            // K̂ as the products read it (kSplit: hi + lo)
            const float2 km =
                S::kSplit ? split_value(kh, *reinterpret_cast<const uint32_t*>(
                                                ss + S::klo +
                                                off16(kBlock, r, c)))
                          : make_float2(lo_f(kh), hi_f(kh));
            if (tok < t_len) {
              float y0 = a0 * ex2(-b.x), y1 = a1 * ex2(-b.y);
              if constexpr (EXCLUSIVE) {   // dk's bonus (do·v) u⊙q
                const float d = tot[r];
                const uint32_t qr = __ldg(
                    reinterpret_cast<const unsigned int*>(q_raw + off + c));
                const float2 uu =
                    __ldg(reinterpret_cast<const float2*>(ur + c));
                y0 += d * uu.x * lo_f(qr);
                y1 += d * uu.y * hi_f(qr);
              }
              *reinterpret_cast<uint32_t*>(dk + off + c) = pack_bf16(y0, y1);
            }
            *bp = make_float2(km.x * a0, km.y * a1);
          } else if (tok < t_len) {
            *reinterpret_cast<uint32_t*>(dv + off + c) = pack_bf16(a0, a1);
          }
        }
      }
    if constexpr (EXCLUSIVE) load_pv();
    __syncthreads();

    // dg: reverse cumulative sum of q⊙dq − K̂ ⊙ acc_k over the tile, plus
    // the later tiles' sum, masked where the clamp held g (EXCLUSIVE:
    // less the token's own q⊙dq)
    if (scans) {
      float acc_s = 0.f;
#pragma unroll
      for (int i = 31; i >= 0; --i) {
        const float qd = pv[i];
        acc_s += qd - *reinterpret_cast<const float*>(
                          ss + S::g + off32(32 * sc_h + i, sc_c));
        pv[i] = EXCLUSIVE ? acc_s - qd : acc_s;
      }
      tot[sc_h * S::GW + sc_c] = acc_s;
    }
    __syncthreads();
    if (scans) {
      const float t0 = tot[sc_c], t1 = tot[S::GW + sc_c];
      const float off = carry + (sc_h == 0 ? t1 : 0.f);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int tok = tok0 + 32 * sc_h + i;
        if (tok < t_len)
          dg[(static_cast<size_t>(row) * t_len + tok) * D + sc_c] =
              (mask >> i) & 1u ? pv[i] + off : 0.f;
      }
      carry += t0 + t1;
    }
    fence_async();
    __syncthreads();   // the stage and the state copy are free
  }
}

// ---------------------------------------------------------------------------
// The exclusive backward at D <= 64 (kSplit: RWKV-6's head dim 64), the
// redesign of decay_sweep_dq_tc / decay_sweep_dkv_tc<D, true> there.
//
// Each tile of a row is a chain of dependent steps (the TMA wait, the
// decay scan and its barriers, the score group, the product group, the
// epilogue), and the row's state carries from tile to tile, so one row
// cannot keep an SM busy: a block of one row (decay_sweep_d*_tc) leaves
// the SM idle through every wait, and at D <= 64 its dq launch leaves a
// warpgroup out of every product. Here a block holds two rows, one per
// warpgroup (warpgroup w takes row 2·blockIdx + w; an odd row count
// leaves the last block's second warpgroup without one), so that one
// row's wgmma groups run while the other waits. Each warpgroup
// synchronises on a named barrier of its own (bar.sync 1 + w, 128) and
// owns its row's state in its accumulator registers, its state copy
// (hi + lo), the low parts of Q̂ and K̂ and its scan totals in a region of
// its own. One ring of three stages (q, k, v, do and g of one tile,
// 48 KiB at D = 64) feeds both rows, their tiles in turn: a stage is full
// when its bytes land (the row's mbarrier full[s]) and free once the 128
// threads of the warpgroup that read it have arrived on empty[s], so
// either row can run up to a tile and a half ahead of the other. Thread 0
// of each warpgroup issues its row's loads (Feeder): at each tile's start,
// while it waits for the tile, and after each product group, it loads the
// row's next tile if its stage has come free. (A producer warpgroup would
// cap the block's 384 threads at 168 registers, and the consumers spilled
// there even with setmaxnreg; two warpgroups keep 255.) Every row of the
// grid is in flight at once: 256 rows take 128 of the 132 SMs. The dk/dv
// launch writes dk, dv and dg into stage slots that its products no longer
// read and stores them by TMA; the row's feeding thread releases the stage
// once the stores have read it, after its next tile has arrived.
//
// What decay_sweep_d*_tc<D, true> read back or summed serially in each
// tile, these take from what the warpgroup already holds:
// - do·v of each token is the diagonal of the score tile dO Vᵀ (dq) or
//   V dOᵀ (dk), read from the accumulators of the quad that holds the
//   token's row (diag_pair), with no pass over the tile and no barrier;
// - the raw k (dq's bonus and du) and q (dk's bonus) of each thread's
//   epilogue elements are read from the tile into registers before K̂ and
//   Q̂ are written over them, and q·(u⊙k) of dv's diagonal is summed from
//   the same registers across the quad; u is read once a row;
// - du is summed in the epilogue's own layout and reduced across the
//   warpgroup once, at the row's end, in a fixed order (du_rows).
// The products, masks, split operands, the 64-token tiles and the strict
// masks are decay_sweep_dq_tc's and decay_sweep_dkv_tc's at DC = 1; the
// dk/dv launch runs dk's and dv's products in turn in one warpgroup.
constexpr int kStagesX = 3;

template <int D>
struct LX {
  using S = L<D>;
  static_assert(S::kSplit, "two rows a block at D <= 64 only");
  static constexpr int stage = S::loaded;              // q, k, v, do, g
  static constexpr int regions = kStagesX * stage;     // two rows' own
  // in a row's region: the low parts of K̂ and Q̂ and the state's copy
  // (hi, lo), one 64-row block each; then the small arrays
  static constexpr int klo = 0, qlo = kBlock, x = 2 * kBlock,
                       xlo = 3 * kBlock;
  static constexpr int btot = 4 * kBlock;              // DP floats
  static constexpr int tot = btot + 4 * S::DP;         // the scan's, GW
  static constexpr int dgtot = tot + 4 * S::GW;        // dg's halves, 2·GW
  static constexpr int u = dgtot + 8 * S::GW;          // the row's u, DP
  static constexpr int red = u + 4 * S::DP;            // du: 4 warps × DP
  static constexpr int row = (red + 16 * S::DP + 1023) / 1024 * 1024;
  // empty[3], then each row's full[3]
  static constexpr int bars = regions + 2 * row;
  static constexpr int bytes = bars + 24 * kStagesX + 1024;
};

// The diagonal of a 64×64 tile in the accumulator layout at this thread's
// rows r0 and r0 + 8: register 4g + 2h + e holds (r0 + 8h, 8g + cl + e),
// so one lane of the quad holds each row's diagonal element, and the
// quad's sum of the elements on the diagonal is it (the others add zero)
__device__ __forceinline__ float2 diag_pair(const float (&s)[32], int r0,
                                            int cl) {
  float d[2] = {0.f, 0.f};
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    const int h = (x >> 1) & 1, c = 8 * (x >> 2) + cl + (x & 1);
    d[h] += c == r0 + 8 * h ? s[x] : 0.f;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    d[h] += __shfl_xor_sync(0xffffffffu, d[h], 1);
    d[h] += __shfl_xor_sync(0xffffffffu, d[h], 2);
  }
  return make_float2(d[0], d[1]);
}

// this thread's epilogue elements of a raw bf16 slot: rows r0 + 8h,
// columns 8g + cl and 8g + cl + 1, as pairs
__device__ __forceinline__ void read_pairs(const uint8_t* slot,
                                           uint32_t (&p)[2][8], int r0,
                                           int cl) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int g = 0; g < 8; ++g)
      p[h][g] = *reinterpret_cast<const uint32_t*>(
          slot + off16(kBlock, r0 + 8 * h, 8 * g + cl));
}

// true once the phase of parity `parity` has completed; does not wait
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.b32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// one box of smem (the 128-byte swizzle's layout) into a 3-D tensor map,
// in this thread's open bulk group; out-of-bounds elements are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One row's loads into the ring, issued by thread 0 of the row's
// warpgroup as stages come free: the block's nr rows take the ring's
// loads in turn (load n is tile n / nr of row n % nr; REVERSE: each row's
// tiles last to first), and load n goes to stage n % 3 once the
// warpgroup that read the stage's previous tile (load n - 3, of either
// row) has released it on empty[s]. Each row issues its own loads, so that
// neither waits on the other's thread, and completes them on full
// barriers of its own (row w's use j of stage s, tile 3j + ..., is phase
// j of its full[s]). A row loads at most one tile past the one it is
// working on: then the stage's previous release that a load tests is at
// most one phase behind, and a parity cannot alias.
template <int D, bool REVERSE>
struct Feeder {
  const CUtensorMap *tq, *tk, *tv, *to, *tg;
  uint32_t base;
  int row0, nr, w, n_tiles, next;   // next: the row's next tile to load

  // issues the row's loads of tiles up to `upto` whose stages are free, in
  // order; returns at the first whose stage is still read
  __device__ __forceinline__ void pump(int upto) {
    using X = LX<D>;
    const uint32_t empty0 = base + X::bars,
                   full0 = empty0 + 8 * kStagesX * (1 + w);
    for (; next < n_tiles && next <= upto; ++next) {
      const int n = next * nr + w, s = n % kStagesX;
      if (n >= kStagesX &&
          !mbar_test(empty0 + 8 * s, (n / kStagesX - 1) & 1))
        return;
      load_tile<D>(base + s * X::stage, full0 + 8 * s, tq, tk, tv, to, tg,
                   (REVERSE ? n_tiles - 1 - next : next) * kTile, row0 + w);
    }
  }

  // the wait for tile `it` of the row on its full barrier; the feeding
  // thread issues the row's loads while it waits (a wait of 2^34 clocks
  // traps, as mbar_wait's)
  __device__ __forceinline__ void wait(int it, bool feeds) {
    const uint32_t bar = base + LX<D>::bars + 8 * kStagesX * (1 + w) +
                         8 * ((it * nr + w) % kStagesX),
                   parity = (it / kStagesX) & 1;
    if (!feeds) {
      mbar_wait(bar, parity);
      return;
    }
    const long long start = clock64();
    while (!mbar_test(bar, parity)) {
      pump(it + 1);
      if (clock64() - start > (1ll << 34)) __trap();
    }
  }
};

// The block's set-up, shared by both launches: the ring's barriers, each
// row's e^{btot} zeroed and its u copied (zero past D), and each row's
// first loads. Returns true in the threads of a warpgroup that owns a row
// (warpgroup 1 owns none when rows is odd, in the last block).
template <int D, bool REVERSE>
__device__ __forceinline__ bool ring_setup(uint8_t* sb, int w,
                                           const float* u, int u_heads,
                                           Feeder<D, REVERSE>& feed) {
  using X = LX<D>;
  const int tid = threadIdx.x;
  const uint32_t empty0 = feed.base + X::bars;
  if (tid == 0) {
    for (int s = 0; s < kStagesX; ++s) {
      mbar_init(empty0 + 8 * s, 128);
      mbar_init(empty0 + 8 * (kStagesX + s), 1);
      mbar_init(empty0 + 8 * (2 * kStagesX + s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (w < feed.nr) {
    uint8_t* const rs = sb + X::regions + w * X::row;
    float* const btot = reinterpret_cast<float*>(rs + X::btot);
    float* const us = reinterpret_cast<float*>(rs + X::u);
    const float* const ur =
        u + static_cast<size_t>((feed.row0 + w) % u_heads) * D;
    for (int c = tid % 128; c < L<D>::DP; c += 128) {
      btot[c] = 0.f;
      us[c] = c < D ? ur[c] : 0.f;
    }
  }
  __syncthreads();
  if (tid % 128 == 0 && w < feed.nr) {
    const CUtensorMap* maps[5] = {feed.tq, feed.tk, feed.tv, feed.to,
                                  feed.tg};
#pragma unroll
    for (int i = 0; i < 5; ++i)
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(maps[i]))
                   : "memory");
    feed.pump(1);
  }
  return w < feed.nr;
}

// The exclusive backward's forward sweep at D <= 64, two rows a block (see
// above): per 64-token tile, as decay_sweep_dq_tc<D, true>,
//     acc = (dO Vᵀ ⊙ M_strict) K̂ + dO Sᵀ ;  S ← e^{btot} ⊙ (S + K̂ᵀ V)
//     dq = e^{b_{t-1}} ⊙ acc + (do·v) u⊙k ;  q⊙dq = Q̂ ⊙ acc
//     du_rows[row] = Σ_t (do_t·v_t) q_t⊙k_t
// grid ⌈rows / 2⌉; block kThreads; dynamic shared memory LX<D>::bytes.
// Tensor maps as decay_sweep_dq_tc's.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
exclusive_dq_tc(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap to,
                const __grid_constant__ CUtensorMap tg,
                __nv_bfloat16* __restrict__ dq, float* __restrict__ qdq,
                const float* __restrict__ u, int u_heads,
                float* __restrict__ du, int rows, int t_len, float lo) {
  using S = L<D>;
  using X = LX<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sb = smem_raw + (base - raw);
  // the warpgroup, from lane 0: provably uniform
  const int w = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int row0 = 2 * blockIdx.x, n_tiles = (t_len + kTile - 1) / kTile;
  const bool feeds = threadIdx.x % 128 == 0;
  Feeder<D, false> feed{&tq, &tk, &tv, &to, &tg, base, row0,
                        min(2, rows - row0), w, n_tiles, 0};
  if (!ring_setup(sb, w, u, u_heads, feed)) return;
  const int nr = feed.nr, row = row0 + w, bar = 1 + w;
  const uint32_t empty0 = base + X::bars;
  uint8_t* const rs = sb + X::regions + w * X::row;
  const uint32_t rb = base + X::regions + w * X::row;
  float* const btot = reinterpret_cast<float*>(rs + X::btot);
  float* const tot = reinterpret_cast<float*>(rs + X::tot);
  const float* const us = reinterpret_cast<const float*>(rs + X::u);

  float x[1][32];   // S, 64 × 64
#pragma unroll
  for (int i = 0; i < 32; ++i) x[0][i] = 0.f;
  float du_acc[16];   // du of columns 8g + cl + e, at 2g + e
#pragma unroll
  for (int i = 0; i < 16; ++i) du_acc[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    // offsets from the thread index, recomputed in each tile
    int t = threadIdx.x % 128;
    asm volatile("" : "+r"(t));
    const int r0 = t / 32 * 16 + (t % 32) / 4, cl = 2 * (t % 4);
    const int n = it * nr + w, s = n % kStagesX;
    const uint32_t st = base + s * X::stage;
    uint8_t* const ss = sb + s * X::stage;
    const int tok0 = it * kTile;
    if (feeds) feed.pump(it + 1);
    feed.wait(it, feeds);

    uint32_t kr[2][8];   // the raw k of the epilogue's elements
    read_pairs(ss + S::k, kr, r0, cl);
    decay_scan<D, true>(ss + S::g, tot, btot, lo, t, bar);
    store_state_split(rs + X::x, rs + X::xlo, x[0], r0, cl);
    split_slot<D, false, 128>(ss + S::k, rs + X::klo, ss + S::g, -1.f, t);
    fence_async();
    sync_threads<true>(bar);

    float sc[32], acc[32];
    uint32_t hi[4][4], lo2[4][4];
    // the score tile dO Vᵀ, alone (its diagonal: do·v)
    fence_regs(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<0, 0>(sc, kdesc(st + S::o, kBlock, kk),
                     kdesc(st + S::v, kBlock, kk), kk > 0);
    wg_commit();
    fence_regs(sc);
    wg_wait<0>();
    fence_regs(sc);
    const float2 dov = diag_pair(sc, r0, cl);
    mask_split_strict<true>(sc, hi, lo2, r0, cl, nullptr);
    // acc = P K̂ + dO Sᵀ (P, K̂ and S's copy in two parts each); beside it
    // S += K̂ᵀ V with K̂ in two parts
    fence_regs(acc);
    fence_regs(x);
    fence_regs(hi);
    fence_regs(lo2);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, hi[kk], mdesc(st + S::k, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, lo2[kk], mdesc(st + S::k, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, hi[kk], mdesc(rb + X::klo, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, lo2[kk], mdesc(rb + X::klo, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<0, 0>(acc, kdesc(st + S::o, kBlock, kk),
                     kdesc(rb + X::xlo, kBlock, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<1, 1>(x[0], mdesc(rb + X::klo, kk), mdesc(st + S::v, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<0, 0>(acc, kdesc(st + S::o, kBlock, kk),
                     kdesc(rb + X::x, kBlock, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<1, 1>(x[0], mdesc(st + S::k, kk), mdesc(st + S::v, kk), 1);
    wg_commit();
    fence_regs(acc);
    fence_regs(x);
    fence_regs(hi);
    fence_regs(lo2);
    wg_wait<0>();
    fence_regs(acc);
    fence_regs(x);
    if (feeds) feed.pump(it + 1);

    // dq = e^{b_{t-1}} acc + (do·v) u⊙k in bf16; q⊙dq = Q̂ acc in fp32,
    // Q̂ = q e^{b_{t-1}} as the dk/dv launch splits it; du += (do·v) q⊙k
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h, tok = tok0 + r;
      if (tok >= t_len) continue;
      const float d = h ? dov.y : dov.x;
      const size_t off = (static_cast<size_t>(row) * t_len + tok) * D;
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int c = 8 * g + cl;
        if (c >= D) continue;
        float2 b = make_float2(0.f, 0.f);
        if (r > 0)
          b = *reinterpret_cast<const float2*>(ss + S::g + off32(r - 1, c));
        const float a0 = acc[4 * g + 2 * h], a1 = acc[4 * g + 2 * h + 1];
        const float2 uu = *reinterpret_cast<const float2*>(us + c);
        const float k0 = lo_f(kr[h][g]), k1 = hi_f(kr[h][g]);
        float y0 = a0 * ex2(b.x), y1 = a1 * ex2(b.y);
        y0 += d * uu.x * k0;
        y1 += d * uu.y * k1;
        *reinterpret_cast<uint32_t*>(dq + off + c) = pack_bf16(y0, y1);
        const uint32_t qr = *reinterpret_cast<const uint32_t*>(
            ss + S::q + off16(kBlock, r, c));
        const float q0 = lo_f(qr) * ex2(b.x), q1 = hi_f(qr) * ex2(b.y);
        const uint32_t qh = pack_bf16(q0, q1);
        const float2 qm =
            split_value(qh, pack_bf16(q0 - lo_f(qh), q1 - hi_f(qh)));
        *reinterpret_cast<float2*>(qdq + off + c) =
            make_float2(qm.x * a0, qm.y * a1);
        du_acc[2 * g] += d * lo_f(qr) * k0;
        du_acc[2 * g + 1] += d * hi_f(qr) * k1;
      }
    }
    decay_state<D>(x, btot, 0, r0);
    fence_async();
    mbar_arrive(empty0 + 8 * s);   // the stage is free
  }

  // du_rows: each column's sums over the lanes that hold it (t % 4), then
  // over the four warps, in a fixed order
  const int t = threadIdx.x % 128, lane = t % 32;
  float* const red = reinterpret_cast<float*>(rs + X::red);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    float v = du_acc[i];
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    du_acc[i] = v;
  }
  if (lane < 4) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      red[(t / 32) * S::DP + 8 * (i / 2) + 2 * lane + i % 2] = du_acc[i];
  }
  sync_threads<true>(bar);
  if (t < D)
    du[static_cast<size_t>(row) * D + t] =
        red[t] + red[S::DP + t] + red[2 * S::DP + t] + red[3 * S::DP + t];
}

// The exclusive backward's reverse sweep at D <= 64, two rows a block:
// per tile, last to first, as decay_sweep_dkv_tc<D, true>,
//     acc_k = (V dOᵀ ⊙ Mᵀ_strict) Q̂ + V Xᵀ
//     dk = e^{-b} ⊙ acc_k + (do·v) u⊙q
//     dv = (K̂ Q̂ᵀ ⊙ Mᵀ_strict + diag(q·(u⊙k))) dO + K̂ X ;  X += Q̂ᵀ dO
//     dg_t = Σ_{s>t} q⊙dq − Σ_{s≥t} K̂ ⊙ acc_k, masked
// with X = R decayed to the tile's start first and Q̂ = q e^{b_{t-1}}.
// One warpgroup computes dk, then dv, of its row. Launch as
// exclusive_dq_tc, with the dq launch's q⊙dq.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
exclusive_dkv_tc(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap to,
                 const __grid_constant__ CUtensorMap tg,
                 const __grid_constant__ CUtensorMap t_dk,
                 const __grid_constant__ CUtensorMap t_dv,
                 const __grid_constant__ CUtensorMap t_dg,
                 const float* __restrict__ qdq,
                 const float* __restrict__ u, int u_heads, int rows,
                 int t_len, float lo) {
  using S = L<D>;
  using X = LX<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sb = smem_raw + (base - raw);
  const int w = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int row0 = 2 * blockIdx.x, n_tiles = (t_len + kTile - 1) / kTile;
  const bool feeds = threadIdx.x % 128 == 0;
  Feeder<D, true> feed{&tq, &tk, &tv, &to, &tg, base, row0,
                       min(2, rows - row0), w, n_tiles, 0};
  if (!ring_setup(sb, w, u, u_heads, feed)) return;
  const int nr = feed.nr, row = row0 + w, bar = 1 + w;
  const uint32_t empty0 = base + X::bars;
  uint8_t* const rs = sb + X::regions + w * X::row;
  const uint32_t rb = base + X::regions + w * X::row;
  float* const btot = reinterpret_cast<float*>(rs + X::btot);
  float* const tot = reinterpret_cast<float*>(rs + X::tot);
  float* const dgtot = reinterpret_cast<float*>(rs + X::dgtot);
  const float* const us = reinterpret_cast<const float*>(rs + X::u);

  float x[1][32];   // R, 64 × 64
#pragma unroll
  for (int i = 0; i < 32; ++i) x[0][i] = 0.f;
  float carry = 0.f;   // dg: the later tiles' sum, channel sc_c

  for (int it = 0; it < n_tiles; ++it) {
    int t = threadIdx.x % 128;
    asm volatile("" : "+r"(t));
    const int r0 = t / 32 * 16 + (t % 32) / 4, cl = 2 * (t % 4);
    // the dg scan's thread: channel sc_c, tokens 32·sc_h.. of the tile
    const int sc_c = t % S::GW, sc_h = t / S::GW;
    const bool scans = t < 2 * S::GW && sc_c < D;
    const int n = it * nr + w, s = n % kStagesX;
    const uint32_t st = base + s * X::stage;
    uint8_t* const ss = sb + s * X::stage;
    const int tok0 = (n_tiles - 1 - it) * kTile;
    if (feeds) feed.pump(it + 1);
    feed.wait(it, feeds);
    if (feeds && it > 0) {   // the previous tile's stores have read it
      bulk_wait_read<0>();
      mbar_arrive(empty0 + 8 * (((it - 1) * nr + w) % kStagesX));
    }

    // the raw q of the epilogue's elements (dk's bonus), and q·(u⊙k) of
    // rows r0 and r0 + 8 (dv's diagonal), summed over the quad
    uint32_t qr[2][8];
    float2 quk;
    {
      uint32_t kr[2][8];
      read_pairs(ss + S::q, qr, r0, cl);
      read_pairs(ss + S::k, kr, r0, cl);
      float p[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const float2 uu =
              *reinterpret_cast<const float2*>(us + 8 * g + cl);
          p[h] += lo_f(qr[h][g]) * uu.x * lo_f(kr[h][g]) +
                  hi_f(qr[h][g]) * uu.y * hi_f(kr[h][g]);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        p[h] += __shfl_xor_sync(0xffffffffu, p[h], 1);
        p[h] += __shfl_xor_sync(0xffffffffu, p[h], 2);
      }
      quk = make_float2(p[0], p[1]);
    }
    const uint32_t mask = decay_scan<D, true>(ss + S::g, tot, btot, lo, t,
                                              bar);
    decay_state<D>(x, btot, 0, r0);
    store_state_split(rs + X::x, rs + X::xlo, x[0], r0, cl);
    split_slot<D, true, 128>(ss + S::q, rs + X::qlo, ss + S::g, 1.f, t);
    split_slot<D, false, 128>(ss + S::k, rs + X::klo, ss + S::g, -1.f, t);
    fence_async();
    sync_threads<true>(bar);

    float acc[32], sc[32];
    uint32_t hi[4][4], lo2[4][4];
    // dk's score tile V dOᵀ, alone (its diagonal: do·v)
    score_tile<D, false>(sc, st + S::v, st + S::o, 0, 0);
    const float2 dov = diag_pair(sc, r0, cl);
    mask_split_strict<false>(sc, hi, lo2, r0, cl, nullptr);
    // acc = S1 Q̂ + V Xᵀ (S1, Q̂ and X's copy in two parts each); beside
    // it X += Q̂ᵀ dO with Q̂ in two parts
    fence_regs(acc);
    fence_regs(x);
    fence_regs(hi);
    fence_regs(lo2);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, hi[kk], mdesc(st + S::q, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, lo2[kk], mdesc(st + S::q, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, hi[kk], mdesc(rb + X::qlo, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, lo2[kk], mdesc(rb + X::qlo, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<0, 0>(acc, kdesc(st + S::v, kBlock, kk),
                     kdesc(rb + X::xlo, kBlock, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<0, 0>(acc, kdesc(st + S::v, kBlock, kk),
                     kdesc(rb + X::x, kBlock, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<1, 1>(x[0], mdesc(st + S::q, kk), mdesc(st + S::o, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<1, 1>(x[0], mdesc(rb + X::qlo, kk), mdesc(st + S::o, kk), 1);
    wg_commit();
    fence_regs(acc);
    fence_regs(x);
    fence_regs(hi);
    fence_regs(lo2);
    wg_wait<0>();
    fence_regs(acc);
    fence_regs(x);
    if (feeds) feed.pump(it + 1);

    // dk = e^{-b} acc_k + (do·v) u⊙q in bf16 over the v slot (free once
    // dk's products are done); K̂ ⊙ acc_k over b, in place
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h, tok = tok0 + r;
      const float d = h ? dov.y : dov.x;
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int c = 8 * g + cl;
        if (c >= D) continue;
        const float a0 = acc[4 * g + 2 * h], a1 = acc[4 * g + 2 * h + 1];
        float2* bp = reinterpret_cast<float2*>(ss + S::g + off32(r, c));
        const float2 b = *bp;
        const int at = off16(kBlock, r, c);
        // K̂ as the products read it: hi + lo
        const float2 km = split_value(
            *reinterpret_cast<const uint32_t*>(ss + S::k + at),
            *reinterpret_cast<const uint32_t*>(rs + X::klo + at));
        if (tok < t_len) {
          const float2 uu = *reinterpret_cast<const float2*>(us + c);
          float y0 = a0 * ex2(-b.x), y1 = a1 * ex2(-b.y);
          y0 += d * uu.x * lo_f(qr[h][g]);
          y1 += d * uu.y * hi_f(qr[h][g]);
          *reinterpret_cast<uint32_t*>(ss + S::v + at) = pack_bf16(y0, y1);
        }
        *bp = make_float2(km.x * a0, km.y * a1);
      }
    }

    // dv's score tile K̂ Q̂ᵀ (three products of the parts), alone
    fence_regs(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<0, 0>(sc, kdesc(st + S::k, kBlock, kk),
                     kdesc(st + S::q, kBlock, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<0, 0>(sc, kdesc(st + S::k, kBlock, kk),
                     kdesc(rb + X::qlo, kBlock, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<0, 0>(sc, kdesc(rb + X::klo, kBlock, kk),
                     kdesc(st + S::q, kBlock, kk), 1);
    wg_commit();
    fence_regs(sc);
    // this tile's q⊙dq for the dg scan, in flight during dv's products
    float pv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int tok = tok0 + 32 * sc_h + i;
      pv[i] = scans && tok < t_len
                  ? __ldg(qdq + (static_cast<size_t>(row) * t_len + tok) * D +
                          sc_c)
                  : 0.f;
    }
    wg_wait<0>();
    fence_regs(sc);
    mask_split_strict_by<false>(sc, hi, lo2, r0, cl, [quk](int, int h) {
      return h ? quk.y : quk.x;
    });
    // dv = S2 dO + K̂ X (S2, K̂ and X's copy in two parts each)
    fence_regs(acc);
    fence_regs(hi);
    fence_regs(lo2);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, hi[kk], mdesc(st + S::o, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, lo2[kk], mdesc(st + S::o, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<0, 1>(acc, kdesc(st + S::k, kBlock, kk),
                     mdesc(rb + X::xlo, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<0, 1>(acc, kdesc(rb + X::klo, kBlock, kk),
                     mdesc(rb + X::x, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<0, 1>(acc, kdesc(st + S::k, kBlock, kk), mdesc(rb + X::x, kk),
                     1);
    wg_commit();
    fence_regs(acc);
    fence_regs(hi);
    fence_regs(lo2);
    wg_wait<0>();
    fence_regs(acc);
    if (feeds) feed.pump(it + 1);
    // dv in bf16 over the q slot (Q̂'s last reader was dk's group)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int g = 0; g < 8; ++g)
        *reinterpret_cast<uint32_t*>(ss + S::q +
                                     off16(kBlock, r0 + 8 * h, 8 * g + cl)) =
            pack_bf16(acc[4 * g + 2 * h], acc[4 * g + 2 * h + 1]);
    sync_threads<true>(bar);   // every K̂ ⊙ acc_k is in the g slot

    // dg: reverse cumulative sum of q⊙dq − K̂ ⊙ acc_k over the tile, less
    // the token's own q⊙dq, plus the later tiles' sum, masked where the
    // clamp held g
    if (scans) {
      float acc_s = 0.f;
#pragma unroll
      for (int i = 31; i >= 0; --i) {
        const float qd = pv[i];
        acc_s += qd - *reinterpret_cast<const float*>(
                          ss + S::g + off32(32 * sc_h + i, sc_c));
        pv[i] = acc_s - qd;
      }
      dgtot[sc_h * S::GW + sc_c] = acc_s;
    }
    sync_threads<true>(bar);
    if (scans) {   // dg in place of K̂ ⊙ acc_k
      const float t0 = dgtot[sc_c], t1 = dgtot[S::GW + sc_c];
      const float off = carry + (sc_h == 0 ? t1 : 0.f);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        *reinterpret_cast<float*>(ss + S::g + off32(32 * sc_h + i, sc_c)) =
            (mask >> i) & 1u ? pv[i] + off : 0.f;
      carry += t0 + t1;
    }
    // the tile's dk, dv and dg out by TMA (rows past T are not written).
    // The stage is free once the stores have read it: the feeding thread
    // releases it after its next tile's scan (or at the end), so that the
    // stores' read does not hold up its own next tile
    fence_async();
    sync_threads<true>(bar);
    if (feeds) {
      tma_store(&t_dk, st + S::v, 0, tok0, row);
      tma_store(&t_dv, st + S::q, 0, tok0, row);
#pragma unroll
      for (int gb = 0; gb < S::GB; ++gb)
        tma_store(&t_dg, st + S::g + gb * kBlock, 32 * gb, tok0, row);
      bulk_commit();
    } else {
      mbar_arrive(empty0 + 8 * s);
    }
  }
  if (feeds) {
    bulk_wait_read<0>();
    mbar_arrive(empty0 + 8 * (((n_tiles - 1) * nr + w) % kStagesX));
  }
}

// The exclusive form's score tile: the strict lower triangle, and
// bonus[row] = q·(u⊙k) on the diagonal, as one bf16 A operand (the layout
// of hopper.cuh's mask_pack)
__device__ __forceinline__ void mask_exclusive(const float (&s)[32],
                                               uint32_t (&p)[4][4], int r0,
                                               int cl, const float* bonus) {
#pragma unroll
  for (int x = 0; x < 32; x += 2) {
    const int r = r0 + 8 * ((x >> 1) & 1), c = 8 * (x >> 2) + cl;
    const float d = bonus[r];
    const float a = c < r ? s[x] : (c == r ? d : 0.f);
    const float b = c + 1 < r ? s[x + 1] : (c + 1 == r ? d : 0.f);
    p[x / 8][(x % 8) / 2] = pack_bf16(a, b);
  }
}

// B8's sweep, on the shape of B9's dq launch: per 64-token tile, with b
// from the tile's start and S[dk][dv] the state at the tile's start,
//     Q̂ = q e^{b} (exclusive: e^{b_{t-1}}) ;  K̂ = k e^{-b}
//     o = (Q̂ K̂ᵀ ⊙ M) V + Q̂ S    (exclusive: M strict, q·(u⊙k) on its
//                                  diagonal)
//     S ← e^{btot} ⊙ (S + K̂ᵀ V)  (rows, per dk)
// and at the end S in fp32, (rows, D, D). Warpgroup wg owns o's columns
// and S's rows 64·wg..64·wg+63 and computes the score tile itself. Launch
// as decay_sweep_dq_tc, with the maps of q, k, v and g.
template <int D, bool EXCLUSIVE>
__global__ void __launch_bounds__(kThreads, 1)
decay_sweep_fwd_tc(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tg,
                   const float* __restrict__ u, int u_heads,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ state,
                   int t_len, float lo) {
  using S = L<D>;
  constexpr int DC = S::DC;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sb = smem_raw + (base - raw);
  float* const btot = reinterpret_cast<float*>(sb + S::btot);
  float* const tot = reinterpret_cast<float*>(sb + S::tot);
  float* const bonus = reinterpret_cast<float*>(sb + S::bonus);
  const uint32_t bar0 = base + S::bars;
  // the warpgroup, from lane 0: provably uniform (see decay_sweep_dq_tc)
  const int tid = threadIdx.x,
            wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int row = blockIdx.x;
  const int n_tiles = (t_len + kTile - 1) / kTile;

  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int c = tid; c < S::DP; c += kThreads) btot[c] = 0.f;
  __syncthreads();
  if (tid == 0)
    load_tile<D, false>(base, bar0, &tq, &tk, &tv, nullptr, &tg, 0, row);

  float x[DC][32];   // S rows 64·wg + (0..63) (wg < DC)
#pragma unroll
  for (int j = 0; j < DC; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) x[j][i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    // offsets from the thread index, recomputed in each tile
    int t = threadIdx.x;
    asm volatile("" : "+r"(t));
    const int r0 = (t % 128) / 32 * 16 + (t % 32) / 4, cl = 2 * (t % 4);
    if (tid == 0 && it + 1 < n_tiles)
      load_tile<D, false>(base + ((it + 1) & 1) * S::stage,
                          bar0 + 8 * ((it + 1) & 1), &tq, &tk, &tv, nullptr,
                          &tg, (it + 1) * kTile, row);
    const uint32_t st = base + (it & 1) * S::stage;
    uint8_t* const ss = sb + (it & 1) * S::stage;
    const int tok0 = it * kTile;
    mbar_wait(bar0 + 8 * (it & 1), (it >> 1) & 1);

    if constexpr (EXCLUSIVE) {
      // the bonus q·(u⊙k) of each token from the raw tile, u of this row's
      // head; read after decay_scan's first barrier
      const float p = token_dot<D>(
          ss + S::q, ss + S::k,
          u + static_cast<size_t>(row % u_heads) * D, t);
      if (t % 4 == 0) bonus[t / 4] = p;
    }
    decay_scan<D>(ss + S::g, tot, btot, lo, t);
    if (wg < DC) store_state_parts<D>(sb, x, wg, r0, cl);
    if constexpr (S::kSplit)                                      // Q̂
      split_slot<D, EXCLUSIVE>(ss + S::q, ss + S::qlo, ss + S::g, 1.f, t);
    else
      scale_slot<D, EXCLUSIVE>(ss + S::q, ss + S::g, 1.f, t);
    split_slot<D>(ss + S::k, ss + S::o, ss + S::g, -1.f, t);     // K̂
    fence_async();
    __syncthreads();

    if (wg < DC) {
      float sc[32], acc[32];
      uint32_t p[4][4], plo[4][4];
      // the score tile Q̂ K̂ᵀ, alone (kSplit: Q̂hi K̂hiᵀ + Q̂hi K̂loᵀ +
      // Q̂lo K̂hiᵀ)
      fence_regs(sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * DC; ++kk)
        wgmma_ss<0, 0>(sc, kdesc(st + S::q, kBlock, kk),
                       kdesc(st + S::k, kBlock, kk), kk > 0);
      if constexpr (S::kSplit) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<0, 0>(sc, kdesc(st + S::q, kBlock, kk),
                         kdesc(st + S::o, kBlock, kk), 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<0, 0>(sc, kdesc(st + S::qlo, kBlock, kk),
                         kdesc(st + S::k, kBlock, kk), 1);
      }
      wg_commit();
      fence_regs(sc);
      wg_wait<0>();
      fence_regs(sc);
      if constexpr (S::kSplit && EXCLUSIVE)
        mask_split_strict<true>(sc, p, plo, r0, cl, bonus);
      else if constexpr (S::kSplit)
        mask_split<true>(sc, p, plo, r0, cl);
      else if constexpr (EXCLUSIVE)
        mask_exclusive(sc, p, r0, cl, bonus);
      else
        mask_pack<true>(sc, p, r0, cl);
      // o = P V + Q̂ S (this warpgroup's 64 columns; kSplit: P and Q̂ and
      // S's copy in two parts each); beside it the state update S += K̂ᵀ V
      // with K̂ as hi + lo (the copy is read, the registers are updated)
      fence_regs(acc);
      fence_regs(x);
      fence_regs(p);
      if constexpr (S::kSplit) fence_regs(plo);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc, p[kk], mdesc(st + S::v + wg * kBlock, kk), kk > 0);
      if constexpr (S::kSplit) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(acc, plo[kk], mdesc(st + S::v, kk), 1);
      }
#pragma unroll
      for (int kk = 0; kk < 4 * DC; ++kk)
        wgmma_ss<0, 1>(acc, kdesc(st + S::q, kBlock, kk),
                       mdesc(base + S::x + wg * S::xblock, kk), 1);
      if constexpr (S::kSplit) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<0, 1>(acc, kdesc(st + S::q, kBlock, kk),
                         mdesc(base + S::xlo, kk), 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<0, 1>(acc, kdesc(st + S::qlo, kBlock, kk),
                         mdesc(base + S::x, kk), 1);
      }
#pragma unroll
      for (int j = 0; j < DC; ++j)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_ss<1, 1>(x[j], mdesc(st + S::k + wg * kBlock, kk),
                         mdesc(st + S::v + j * kBlock, kk), 1);
          wgmma_ss<1, 1>(x[j], mdesc(st + S::o + wg * kBlock, kk),
                         mdesc(st + S::v + j * kBlock, kk), 1);
        }
      wg_commit();
      fence_regs(acc);
      fence_regs(x);
      fence_regs(p);
      if constexpr (S::kSplit) fence_regs(plo);
      wg_wait<0>();
      fence_regs(acc);
      fence_regs(x);

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h, tok = tok0 + r;
        if (tok >= t_len) continue;
        const size_t off = (static_cast<size_t>(row) * t_len + tok) * D;
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const int c = 64 * wg + 8 * g + cl;
          if (c >= D) continue;
          *reinterpret_cast<uint32_t*>(o + off + c) =
              pack_bf16(acc[4 * g + 2 * h], acc[4 * g + 2 * h + 1]);
        }
      }
      decay_state<D>(x, btot, wg, r0);
    }
    fence_async();
    __syncthreads();   // the stage and the state copy are free
  }

  if (wg < DC) {   // the final state, fp32
    const int r0 = (tid % 128) / 32 * 16 + (tid % 32) / 4, cl = 2 * (tid % 4);
    float* const s_row = state + static_cast<size_t>(row) * D * D;
#pragma unroll
    for (int j = 0; j < DC; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 64 * wg + r0 + 8 * h;
        if (r >= D) continue;
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const int c = 64 * j + 8 * g + cl;
          if (c >= D) continue;
          *reinterpret_cast<float2*>(s_row + r * D + c) =
              make_float2(x[j][4 * g + 2 * h], x[j][4 * g + 2 * h + 1]);
        }
      }
  }
}

// The launches of B9's two sweeps, inclusive or EXCLUSIVE (the exclusive
// form's backward: u, u_heads, the raw k or q for the bonus, du_rows)
// (the exclusive form at D <= 64: exclusive_dq_tc, two rows a block)
template <int D, bool EXCLUSIVE>
int launch_dq(const void* q, const void* k, const void* v, const void* g,
              const void* d_o, const void* u, int u_heads, void* dq,
              void* qdq, void* du, int rows, int t_len, float lo,
              cudaStream_t stream) {
  static bool configured = false;
  constexpr bool kPair = EXCLUSIVE && L<D>::kSplit;
  int err = 0;
  if constexpr (kPair)
    err = configure(exclusive_dq_tc<D>, LX<D>::bytes, configured);
  else
    err = configure(decay_sweep_dq_tc<D, EXCLUSIVE>, L<D>::bytes,
                    configured);
  CUtensorMap m[5];
  if (!err) err = tensor_maps(m, {q, k, v, d_o, g}, 4, D, t_len, rows);
  if (err) return err;
  if constexpr (kPair)
    exclusive_dq_tc<D><<<(rows + 1) / 2, kThreads, LX<D>::bytes, stream>>>(
        m[0], m[1], m[2], m[3], m[4], static_cast<__nv_bfloat16*>(dq),
        static_cast<float*>(qdq), static_cast<const float*>(u), u_heads,
        static_cast<float*>(du), rows, t_len, lo);
  else
    decay_sweep_dq_tc<D, EXCLUSIVE><<<rows, kThreads, L<D>::bytes, stream>>>(
        m[0], m[1], m[2], m[3], m[4], static_cast<__nv_bfloat16*>(dq),
        static_cast<float*>(qdq), static_cast<const __nv_bfloat16*>(k),
        static_cast<const float*>(u), u_heads, static_cast<float*>(du),
        t_len, lo);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool EXCLUSIVE>
int launch_dkv(const void* q, const void* k, const void* v, const void* g,
               const void* d_o, const void* u, int u_heads, const void* qdq,
               void* dk, void* dv, void* dg, int rows, int t_len, float lo,
               cudaStream_t stream) {
  static bool configured = false;
  constexpr bool kPair = EXCLUSIVE && L<D>::kSplit;
  int err = 0;
  if constexpr (kPair)
    err = configure(exclusive_dkv_tc<D>, LX<D>::bytes, configured);
  else
    err = configure(decay_sweep_dkv_tc<D, EXCLUSIVE>, L<D>::bytes,
                    configured);
  CUtensorMap m[5];
  if (!err) err = tensor_maps(m, {q, k, v, d_o, g}, 4, D, t_len, rows);
  if (err) return err;
  CUtensorMap out[3];
  if constexpr (kPair) {
    err = tensor_maps(out, {dk, dv, dg}, 2, D, t_len, rows);
    if (err) return err;
    exclusive_dkv_tc<D><<<(rows + 1) / 2, kThreads, LX<D>::bytes,
                          stream>>>(
        m[0], m[1], m[2], m[3], m[4], out[0], out[1], out[2],
        static_cast<const float*>(qdq), static_cast<const float*>(u),
        u_heads, rows, t_len, lo);
  } else
    decay_sweep_dkv_tc<D, EXCLUSIVE><<<rows, kThreads, L<D>::bytes,
                                       stream>>>(
        m[0], m[1], m[2], m[3], m[4], static_cast<const float*>(qdq),
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
        static_cast<float*>(dg), static_cast<const __nv_bfloat16*>(q),
        static_cast<const float*>(u), u_heads, t_len, lo);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool EXCLUSIVE>
int launch_fwd(const void* q, const void* k, const void* v, const void* g,
               const void* u, int u_heads, void* o, void* s, int rows,
               int t_len, float lo, cudaStream_t stream) {
  static bool configured = false;
  int err = configure(decay_sweep_fwd_tc<D, EXCLUSIVE>, L<D>::bytes,
                      configured);
  CUtensorMap m[4];
  if (!err) err = tensor_maps(m, {q, k, v, g}, 3, D, t_len, rows);
  if (err) return err;
  decay_sweep_fwd_tc<D, EXCLUSIVE><<<rows, kThreads, L<D>::bytes, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(u), u_heads,
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(s), t_len, lo);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
struct Dim {
  static constexpr int value = D;
};

// fn(Dim<D>{}) for the head dims the tensor-core routes take
template <typename F>
int by_head_dim(int d, F fn) {
  switch (d) {
    case 16:
      return fn(Dim<16>{});
    case 64:
      return fn(Dim<64>{});
    case 96:
      return fn(Dim<96>{});
    case 112:
      return fn(Dim<112>{});
    case 128:
      return fn(Dim<128>{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

bool bad_shape(int rows, int t_len) { return rows <= 0 || t_len <= 0; }

}  // namespace

// Every pointer is a contiguous (rows, t, d) tensor on the current
// device: q, k, v, do and o, dv of one type, fp32 (bf16 == 0) or bf16
// (bf16 == 1); g, q⊙dq and dg fp32; dq and dk in the inputs' type; u
// (u_heads, d) fp32, row r reading u[r % u_heads] (rows batch-major, heads
// minor; u_heads divides rows); s the (rows, d, d) fp32 final state; du
// the (rows, d) fp32 du_rows. d in {16, 64, 96, 112, 128}. The bf16 routes
// (tensor cores) take 16-byte aligned inputs. Each returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for
// arguments it does not take, or 10000 + the driver's CUresult when a
// tensor map cannot be made.

// B8: o and the final state; inclusive, or exclusive with the bonus u of
// each row's head (RWKV-6's per-head u). bf16 on the tensor cores, fp32 on
// FMAs.
extern "C" int gated_linear_attention_fwd(const void* q, const void* k,
                                          const void* v, const void* g,
                                          const void* u, void* o, void* s,
                                          int rows, int t, int d, int bf16,
                                          int exclusive, int u_heads,
                                          float min_log_decay, void* stream) {
  if (bad_shape(rows, t) || s == nullptr ||
      (exclusive && (u == nullptr || u_heads < 1 || rows % u_heads)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!exclusive) u_heads = 1;
  if (bf16) {
    if (tc::misaligned(q, k, v, g))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return tc::by_head_dim(d, [&](auto dim) {
      constexpr int D = decltype(dim)::value;
      return exclusive ? tc::launch_fwd<D, true>(q, k, v, g, u, u_heads, o,
                                                 s, rows, t, min_log_decay,
                                                 st)
                       : tc::launch_fwd<D, false>(q, k, v, g, u, 1, o, s,
                                                  rows, t, min_log_decay, st);
    });
  }
  const int mode = exclusive ? kFwdExclusive : kFwd;
  const auto sw = sweep(q, k, v, o, mode);
  return launch_d<false, true>(sw, sw, 1, g, u, u_heads, s, rows, t, d,
                               min_log_decay, stream);
}

// B9, forward sweep: dq = e^{b} ⊙ [(dO Vᵀ ⊙ M) K̂ + dO Sᵀ] in the inputs'
// type. bf16 (tensor cores) also writes q⊙dq (fp32) for the dk/dv launch's
// dg; fp32 (FMAs) writes dq only, and q and q⊙dq are not read.
extern "C" int gated_linear_attention_bwd_dq(const void* q, const void* k,
                                             const void* v, const void* g,
                                             const void* d_o, void* dq,
                                             void* qdq, int rows, int t,
                                             int d, int bf16,
                                             float min_log_decay,
                                             void* stream) {
  if (bad_shape(rows, t)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (qdq == nullptr || tc::misaligned(q, k, v, g, d_o))
      return static_cast<int>(cudaErrorInvalidValue);
    return tc::by_head_dim(d, [&](auto dim) {
      return tc::launch_dq<decltype(dim)::value, false>(
          q, k, v, g, d_o, nullptr, 1, dq, qdq, nullptr, rows, t,
          min_log_decay, st);
    });
  }
  const auto sw = sweep(d_o, v, k, dq, kDq);
  return launch_d<false, false>(sw, sw, 1, g, nullptr, 1, nullptr, rows, t,
                                d, min_log_decay, stream);
}

// B9, reverse sweep: dk = e^{-b} ⊙ [(V dOᵀ ⊙ Mᵀ) Q̂ + V R'ᵀ] and
// dv = (K̂ Q̂ᵀ ⊙ Mᵀ) dO + K̂ R', one launch, in the inputs' type. bf16
// (tensor cores) also writes dg from the dq launch's q⊙dq; fp32 (FMAs)
// writes dk and dv only, and q⊙dq and dg are not touched.
extern "C" int gated_linear_attention_bwd_dkv(const void* q, const void* k,
                                              const void* v, const void* g,
                                              const void* d_o,
                                              const void* qdq, void* dk,
                                              void* dv, void* dg, int rows,
                                              int t, int d, int bf16,
                                              float min_log_decay,
                                              void* stream) {
  if (bad_shape(rows, t)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (qdq == nullptr || dg == nullptr || tc::misaligned(q, k, v, g, d_o))
      return static_cast<int>(cudaErrorInvalidValue);
    return tc::by_head_dim(d, [&](auto dim) {
      return tc::launch_dkv<decltype(dim)::value, false>(
          q, k, v, g, d_o, nullptr, 1, qdq, dk, dv, dg, rows, t,
          min_log_decay, st);
    });
  }
  return launch_d<true, false>(sweep(v, d_o, q, dk, kDk),
                               sweep(k, q, d_o, dv, kDv), 2, g, nullptr, 1,
                               nullptr, rows, t, d, min_log_decay, stream);
}

// The exclusive form's backward (B8's exclusive route with the bonus u;
// no Pallas original: JAX differentiates chunked_gla(exclusive=True, u)
// with jnp autodiff), B9's two sweeps with the strict mask, q scaled by
// e^{b_{t-1}} and the bonus terms.
// Forward sweep: dq = e^{b_{t-1}} ⊙ [(dO Vᵀ ⊙ M_strict) K̂ + dO Sᵀ] +
// (do·v) u⊙k in the inputs' type. bf16 (tensor cores) also writes the
// decay's share of q⊙dq (fp32, for the dk/dv launch's dg) and du_rows =
// Σ_t (do·v) q⊙k per row (fp32; the caller sums each head's rows); fp32
// (FMAs) writes dq only.
extern "C" int gated_linear_attention_bwd_exclusive_dq(
    const void* q, const void* k, const void* v, const void* g,
    const void* d_o, const void* u, void* dq, void* qdq, void* du, int rows,
    int t, int d, int bf16, int u_heads, float min_log_decay, void* stream) {
  if (bad_shape(rows, t) || u == nullptr || u_heads < 1 || rows % u_heads)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (qdq == nullptr || du == nullptr ||
        tc::misaligned(q, k, v, g, d_o) || tc::misaligned(u, du, u))
      return static_cast<int>(cudaErrorInvalidValue);
    return tc::by_head_dim(d, [&](auto dim) {
      return tc::launch_dq<decltype(dim)::value, true>(
          q, k, v, g, d_o, u, u_heads, dq, qdq, du, rows, t, min_log_decay,
          st);
    });
  }
  const auto sw = sweep(d_o, v, k, dq, kDqExclusive);
  return launch_d<false, false>(sw, sw, 1, g, u, u_heads, nullptr, rows, t,
                                d, min_log_decay, stream);
}

// Reverse sweep: dk = e^{-b} ⊙ [(V dOᵀ ⊙ Mᵀ_strict) Q̂ + V R'ᵀ] + (do·v)
// u⊙q and dv = (K̂ Q̂ᵀ ⊙ Mᵀ_strict + diag(q·(u⊙k))) dO + K̂ R', Q̂ = q
// e^{b_{t-1}}, one launch, in the inputs' type. bf16 (tensor cores) also
// writes dg_t = Σ_{s>t} q⊙dq − Σ_{s≥t} k⊙dk (masked) from the dq launch's
// q⊙dq; fp32 (FMAs) writes dk and dv only.
extern "C" int gated_linear_attention_bwd_exclusive_dkv(
    const void* q, const void* k, const void* v, const void* g,
    const void* d_o, const void* u, const void* qdq, void* dk, void* dv,
    void* dg, int rows, int t, int d, int bf16, int u_heads,
    float min_log_decay, void* stream) {
  if (bad_shape(rows, t) || u == nullptr || u_heads < 1 || rows % u_heads)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (qdq == nullptr || dg == nullptr || tc::misaligned(q, k, v, g, d_o) ||
        tc::misaligned(u, qdq, u))
      return static_cast<int>(cudaErrorInvalidValue);
    return tc::by_head_dim(d, [&](auto dim) {
      return tc::launch_dkv<decltype(dim)::value, true>(
          q, k, v, g, d_o, u, u_heads, qdq, dk, dv, dg, rows, t,
          min_log_decay, st);
    });
  }
  return launch_d<true, false>(sweep(v, d_o, q, dk, kDkExclusive),
                               sweep(k, q, d_o, dv, kDvExclusive), 2, g, u,
                               u_heads, nullptr, rows, t, d, min_log_decay,
                               stream);
}
