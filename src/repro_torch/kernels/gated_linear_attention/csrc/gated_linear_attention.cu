// Chunked gated (decay) linear attention and its recompute backward, for
// sm_90a.
//
// Replaces repro/kernels/gated_linear_attention/kernel.py:
//   fwd (B8, _fwd_kernel; pallas_call at :98) -> gated_linear_attention_fwd
//   bwd (B9, _dq_kernel at :212, _dkv_kernel at :232, and its jnp dg
//        epilogue at :255-261)  -> gated_linear_attention_bwd_dq
//                                  gated_linear_attention_bwd_dkv
//
// The paper's §4 decay form, per (batch·head) row: with a_t = exp(g_t),
// g clamped to [min_log_decay, 0],
//     S_t = diag(a_t) S_{t-1} + k_t v_tᵀ ;   o_t = S_tᵀ q_t   (inclusive)
// or o_t = (S_{t-1} + diag(u) k_t v_tᵀ)ᵀ q_t (exclusive + u, RWKV-6).
// B9 returns dq, dk, dv and dg = reverse-cumsum(q⊙dq − k⊙dk), zero where
// the clamp held g. Only q, k, v, g and do are read: no state is stored,
// the paper's memory argument.
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

// What one sweep computes; see the header.
enum Mode : int { kFwd = 0, kFwdExclusive = 1, kDq = 2, kDk = 3, kDv = 4 };

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

// grid (rows, D / DS, sweeps); block Cfg<D>::kThreads; dynamic shared
// memory smem_floats<D>() floats. blockIdx.z picks s0 or s1. g is the
// (rows, t, D) fp32 log-decay; u the (D,) bonus (kFwdExclusive only).
// With EMIT_STATE (B8 only), state receives the final S (rows, D, D)
// fp32. The instantiations: <false, true> B8, <false, false> dq,
// <true, false> dk/dv.
template <int D, bool REVERSE, bool EMIT_STATE>
__global__ void __launch_bounds__(Cfg<D>::kThreads)
decay_sweep(Sweep s0, Sweep s1, const float* __restrict__ g,
            const float* __restrict__ u, float* __restrict__ state,
            int t_len, float min_log_decay) {
  using C = Cfg<D>;
  constexpr int kThreads = C::kThreads;
  constexpr int TC = C::kTile, DS = C::kSlice;
  constexpr int LA = D + 1, LC = DS + 1, LP = TC + 1;
  constexpr int kLanes = D < 32 ? D : 32;   // lanes that share a row
  static_assert(D % DS == 0 && TC % C::kPm == 0 && TC % C::kPn == 0 &&
                    TC % C::kOm == 0 && DS % C::kOn == 0 &&
                    D % C::kSm == 0 && DS % C::kSn == 0,
                "tiling does not divide");
  static_assert(C::kPm * C::kPn == kThreads && C::kOm * C::kOn == kThreads &&
                    C::kSm * C::kSn == kThreads,
                "thread grids must cover the block");
  static_assert(kThreads >= D && (TC * D) % kThreads == 0 &&
                    kThreads % 32 == 0 && 32 % kLanes == 0,
                "the cumulative sum and the bonus reduction need these");

  extern __shared__ float smem[];
  float* As = smem;
  float* Bs = As + TC * LA;
  float* Gs = Bs + TC * LA;    // b: cumulative log-decay from the tile start
  float* Cs = Gs + TC * LA;
  float* Ps = Cs + TC * LC;
  float* Ss = Ps + TC * LP;
  float* Et = Ss + D * LC;     // exp(btot) per channel
  float* Dg = Et + D;          // diagonal bonus q·(u⊙k) per row

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
  const bool decay_cols = mode == kDq || mode == kDk;

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
      if (mode == kFwd) {
        av *= expf(b);
        bv *= expf(-b);
      } else if (mode == kFwdExclusive) {
        // the bonus q_t·(u⊙k_t) from the unscaled row, reduced over the
        // lanes that share the row (uniform branch: every lane is here)
        float p = av * u[col] * bv;
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1)
          p += __shfl_xor_sync(0xffffffffu, p, off);
        if ((tid % kLanes) == 0) atomicAdd(&Dg[r], p);
        av *= r > 0 ? expf(Gs[(r - 1) * LA + col]) : 1.f;   // e^{b_{t-1}}
        bv *= expf(-b);
      } else if (mode == kDv) {
        av *= expf(-b);
        bv *= expf(b);
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
      if (mode == kDq) cv *= expf(-Gs[r * LA + col0 + col]);
      if (mode == kDk) cv *= expf(Gs[r * LA + col0 + col]);
      Cs[r * LC + col] = cv;
    }
    if (REVERSE) {   // R, decayed to the end of this tile -> to its start
      for (int e = tid; e < D * DS; e += kThreads) {
        const int i = e / DS, j = e % DS;
        Ss[i * LC + j] *= decay_cols ? Et[col0 + j] : Et[i];
      }
    }
    __syncthreads();

    // -- scores P = (A Bᵀ) ⊙ M (strict, plus the bonus, when exclusive) ---
    {
      constexpr int MT = C::kPm, NT = C::kPn, RM = TC / MT, RN = TC / NT;
      const int ti = tid / NT, tj = tid % NT;
      const bool strict = mode == kFwdExclusive;
      float acc[RM][RN] = {};
      mma<RM, RN, MT, NT, D>(acc, As, LA, 1, Bs, 1, LA, ti, tj);
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < RN; ++c) {
          const int i = ti + r * MT, j = tj + c * NT;
          float p = (j < i || (j == i && !strict)) ? acc[r][c] : 0.f;
          if (strict && j == i) p = Dg[i];
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
            const float scale = mode == kDq   ? expf(Gs[i * LA + col])
                                : mode == kDk ? expf(-Gs[i * LA + col])
                                              : 1.f;
            sw.out[row_off + off] = acc[r][c] * scale;
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
           const float* u, float* state, int rows, int t_len,
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
  kernel<<<grid, block, kSmem, stream>>>(s0, s1, g, u, state, t_len,
                                         min_log_decay);
  return static_cast<int>(cudaGetLastError());
}

template <bool REVERSE, bool EMIT_STATE>
int launch_d(Sweep s0, Sweep s1, int n_sweeps, const void* g,
             const void* u, void* state, int rows, int t_len, int d,
             float min_log_decay, void* stream) {
  const float* gf = static_cast<const float*>(g);
  const float* uf = static_cast<const float*>(u);
  float* sf = static_cast<float*>(state);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return launch<16, REVERSE, EMIT_STATE>(s0, s1, n_sweeps, gf, uf, sf,
                                             rows, t_len, min_log_decay, st);
    case 128:
      return launch<128, REVERSE, EMIT_STATE>(s0, s1, n_sweeps, gf, uf, sf,
                                              rows, t_len, min_log_decay, st);
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
// g: GB blocks of [64 tokens][32 fp32]}, every block as TMA writes it
// with the 128-byte swizzle; the state's bf16 copy, DC blocks of
// [DP rows][64 bf16], swizzled the same way; e^{btot} (log2 units) per
// channel; the scans' per-channel totals; B8's diagonal bonus per token
// (exclusive form); two mbarriers.
template <int D>
struct L {
  static constexpr int DC = (D + 63) / 64;     // 64-column bf16 blocks
  static constexpr int DP = 64 * DC;           // D padded to them
  static constexpr int GB = (D + 31) / 32;     // 32-column fp32 blocks
  static constexpr int GW = 32 * GB;           // channels the scans take
  static constexpr int tile = DC * kBlock;     // one bf16 tensor's tile
  static constexpr int q = 0, k = tile, v = 2 * tile, o = 3 * tile,
                       g = 4 * tile;
  static constexpr int stage = 4 * tile + GB * kBlock;
  static constexpr int x = 2 * stage;
  static constexpr int xblock = DP * kRowBytes;
  static constexpr int btot = x + DC * xblock;
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

// The tile's cumulative clamped log-decay b (inclusive, from the tile's
// first token, per channel), written over g in log2 units, and
// btot[c] = b of the last token. Thread (c, h) = (tid % GW, tid / GW)
// takes tokens 32h..32h+31 of channel c (threads past 2·GW only meet the
// barriers) and returns the clamp's mask for them: bit i is set where
// min_log_decay <= g <= 0 at token 32h + i. Ends with the block in step.
template <int D>
__device__ __forceinline__ uint32_t decay_scan(uint8_t* gs, float* tot,
                                               float* btot, float lo,
                                               int tid) {
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
  __syncthreads();
  if (on) {
    const float off = h ? tot[c] : 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      *reinterpret_cast<float*>(gs + off32(32 * h + i, c)) =
          (loc[i] + off) * kLog2e;
    if (h) btot[c] = (loc[31] + off) * kLog2e;
  }
  __syncthreads();
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

// B8's K̂ = k · 2^(-b) in two bf16 parts: hi over the k slot, lo = bf16(K̂ −
// hi) into `lo_slot` (the stage's do slot, which B8 does not load; its
// columns past D are zeroed), so that the state update K̂ᵀ V carries K̂ to
// about 16 bits and the emitted fp32 state keeps fp32's accuracy
template <int D>
__device__ __forceinline__ void split_slot(uint8_t* slot, uint8_t* lo_slot,
                                           const uint8_t* gs, int tid) {
  using S = L<D>;
  for (int e = tid; e < S::DC * 64 * 8; e += kThreads) {
    const int blk = e >> 9, r = (e >> 3) & 63, ch = e & 7;
    const int c0 = blk * 64 + ch * 8;
    const int at = blk * kBlock + r * kRowBytes + ((ch ^ (r & 7)) << 4);
    uint4* p = reinterpret_cast<uint4*>(slot + at);
    uint4* q = reinterpret_cast<uint4*>(lo_slot + at);
    if (c0 >= D) {
      *q = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const float4 b0 = *reinterpret_cast<const float4*>(gs + off32(r, c0));
    const float4 b1 =
        *reinterpret_cast<const float4*>(gs + off32(r, c0 + 4));
    const uint4 x = *p;
    const float y[8] = {lo_f(x.x) * ex2(-b0.x), hi_f(x.x) * ex2(-b0.y),
                        lo_f(x.y) * ex2(-b0.z), hi_f(x.y) * ex2(-b0.w),
                        lo_f(x.z) * ex2(-b1.x), hi_f(x.z) * ex2(-b1.y),
                        lo_f(x.w) * ex2(-b1.z), hi_f(x.w) * ex2(-b1.w)};
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
  mbar_expect_tx(bar, DO ? S::stage : S::stage - S::tile);
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

// B9's forward sweep: per 64-token tile, with b from the tile's start and
// S[dk][dv] the state at the tile's start,
//     acc = (dO Vᵀ ⊙ M) K̂ + dO Sᵀ ;  dq = e^{b} ⊙ acc ;  q⊙dq = Q̂ ⊙ acc
//     S ← e^{btot} ⊙ (S + K̂ᵀ V)           (rows, per dk)
// grid (rows); block kThreads; dynamic shared memory L<D>::bytes. Tensor
// maps (D, T, rows) with boxes (64, 64, 1) for q, k, v, do and (32, 64, 1)
// for g.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
decay_sweep_dq_tc(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap to,
                  const __grid_constant__ CUtensorMap tg,
                  __nv_bfloat16* __restrict__ dq, float* __restrict__ qdq,
                  int t_len, float lo) {
  using S = L<D>;
  constexpr int DC = S::DC;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sb = smem_raw + (base - raw);
  float* const btot = reinterpret_cast<float*>(sb + S::btot);
  float* const tot = reinterpret_cast<float*>(sb + S::tot);
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

    decay_scan<D>(ss + S::g, tot, btot, lo, t);
    if (wg < DC) store_state(sb + S::x, S::xblock, x, wg, r0, cl);
    scale_slot<D>(ss + S::k, ss + S::g, -1.f, t);        // K̂
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

      // dq = e^{b} acc in bf16; q⊙dq = Q̂ acc in fp32
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h, tok = tok0 + r;
        if (tok >= t_len) continue;
        const size_t off = (static_cast<size_t>(row) * t_len + tok) * D;
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const int c = 64 * wg + 8 * g + cl;
          if (c >= D) continue;
          const float2 b =
              *reinterpret_cast<const float2*>(ss + S::g + off32(r, c));
          const float a0 = acc[4 * g + 2 * h], a1 = acc[4 * g + 2 * h + 1];
          *reinterpret_cast<uint32_t*>(dq + off + c) =
              pack_bf16(a0 * ex2(b.x), a1 * ex2(b.y));
          const uint32_t qh = scale_pair(
              *reinterpret_cast<const uint32_t*>(ss + S::q +
                                                 off16(kBlock, r, c)),
              b.x, b.y);
          *reinterpret_cast<float2*>(qdq + off + c) =
              make_float2(lo_f(qh) * a0, hi_f(qh) * a1);
        }
      }
      decay_state<D>(x, btot, wg, r0);
    }
    fence_async();
    __syncthreads();   // the stage and the state copy are free
  }
}

// The dk/dv launch's products for warpgroup WG, straight-line (a branch
// inside an open wgmma group makes ptxas serialize it): per 64 columns j,
// acc_k = S1 Q̂ + V Xᵀ (WG 0) or dv = S2 dO + K̂ X (WG 1), S1 or S2 as the
// hi and lo parts; beside them the update X += Q̂ᵀ dO of its state rows.
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
// with q⊙dq from the dq launch. Launch as decay_sweep_dq_tc.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
decay_sweep_dkv_tc(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap to,
                   const __grid_constant__ CUtensorMap tg,
                   const float* __restrict__ qdq,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, float* __restrict__ dg,
                   int t_len, float lo) {
  using S = L<D>;
  constexpr int DC = S::DC;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sb = smem_raw + (base - raw);
  float* const btot = reinterpret_cast<float*>(sb + S::btot);
  float* const tot = reinterpret_cast<float*>(sb + S::tot);
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

    const uint32_t mask = decay_scan<D>(ss + S::g, tot, btot, lo, t);
    if (wg < DC) {
      decay_state<D>(x, btot, wg, r0);
      store_state(sb + S::x, S::xblock, x, wg, r0, cl);
    }
    scale_slot<D>(ss + S::q, ss + S::g, 1.f, t);         // Q̂
    scale_slot<D>(ss + S::k, ss + S::g, -1.f, t);        // K̂
    fence_async();
    __syncthreads();

    float acc[DC][32];
    {
      float sc[32];
      uint32_t hi[4][4], lo2[4][4];
      // this warpgroup's score tile, alone (as in the dq launch): V dOᵀ
      // for dk, K̂ Q̂ᵀ for dv
      const uint32_t sa = st + (wg ? S::k : S::v);
      const uint32_t sb2 = st + (wg ? S::q : S::o);
      fence_regs(sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * DC; ++kk)
        wgmma_ss<0, 0>(sc, kdesc(sa, kBlock, kk), kdesc(sb2, kBlock, kk),
                       kk > 0);
      wg_commit();
      fence_regs(sc);
      wg_wait<0>();
      fence_regs(sc);
      mask_split<false>(sc, hi, lo2, r0, cl);

      if (wg == 0)
        dkv_products<D, 0>(acc, x, hi, lo2, st, base);
      else
        dkv_products<D, 1>(acc, x, hi, lo2, st, base);
    }

    // this tile's q⊙dq for the dg scan, in flight during the epilogue
    float pv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int tok = tok0 + 32 * sc_h + i;
      pv[i] = scans && tok < t_len
                  ? __ldg(qdq + (static_cast<size_t>(row) * t_len + tok) * D +
                          sc_c)
                  : 0.f;
    }

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
            if (tok < t_len)
              *reinterpret_cast<uint32_t*>(dk + off + c) =
                  pack_bf16(a0 * ex2(-b.x), a1 * ex2(-b.y));
            *bp = make_float2(lo_f(kh) * a0, hi_f(kh) * a1);
          } else if (tok < t_len) {
            *reinterpret_cast<uint32_t*>(dv + off + c) = pack_bf16(a0, a1);
          }
        }
      }
    __syncthreads();

    // dg: reverse cumulative sum of q⊙dq − K̂ ⊙ acc_k over the tile, plus
    // the later tiles' sum, masked where the clamp held g
    if (scans) {
      float acc_s = 0.f;
#pragma unroll
      for (int i = 31; i >= 0; --i) {
        acc_s += pv[i] - *reinterpret_cast<const float*>(
                             ss + S::g + off32(32 * sc_h + i, sc_c));
        pv[i] = acc_s;
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
                   const float* __restrict__ u,
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
      // the bonus q·(u⊙k) of each token from the raw tile, four threads a
      // token; read after decay_scan's first barrier
      const int r = t / 4, part = t % 4;
      float p = 0.f;
#pragma unroll
      for (int c = 2 * part; c < D; c += 8) {
        const uint32_t qa = *reinterpret_cast<const uint32_t*>(
            ss + S::q + off16(kBlock, r, c));
        const uint32_t ka = *reinterpret_cast<const uint32_t*>(
            ss + S::k + off16(kBlock, r, c));
        p += lo_f(qa) * __ldg(u + c) * lo_f(ka) +
             hi_f(qa) * __ldg(u + c + 1) * hi_f(ka);
      }
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      if (part == 0) bonus[r] = p;
    }
    decay_scan<D>(ss + S::g, tot, btot, lo, t);
    if (wg < DC) store_state(sb + S::x, S::xblock, x, wg, r0, cl);
    scale_slot<D, EXCLUSIVE>(ss + S::q, ss + S::g, 1.f, t);      // Q̂
    split_slot<D>(ss + S::k, ss + S::o, ss + S::g, t);           // K̂
    fence_async();
    __syncthreads();

    if (wg < DC) {
      float sc[32], acc[32];
      uint32_t p[4][4];
      // the score tile Q̂ K̂ᵀ, alone
      fence_regs(sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * DC; ++kk)
        wgmma_ss<0, 0>(sc, kdesc(st + S::q, kBlock, kk),
                       kdesc(st + S::k, kBlock, kk), kk > 0);
      wg_commit();
      fence_regs(sc);
      wg_wait<0>();
      fence_regs(sc);
      if constexpr (EXCLUSIVE)
        mask_exclusive(sc, p, r0, cl, bonus);
      else
        mask_pack<true>(sc, p, r0, cl);
      // o = P V + Q̂ S (this warpgroup's 64 columns); beside it the state
      // update S += K̂ᵀ V with K̂ as hi + lo (the copy is read, the
      // registers are updated)
      fence_regs(acc);
      fence_regs(x);
      fence_regs(p);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc, p[kk], mdesc(st + S::v + wg * kBlock, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4 * DC; ++kk)
        wgmma_ss<0, 1>(acc, kdesc(st + S::q, kBlock, kk),
                       mdesc(base + S::x + wg * S::xblock, kk), 1);
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

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* g,
              const void* d_o, void* dq, void* qdq, int rows, int t_len,
              float lo, cudaStream_t stream) {
  static bool configured = false;
  int err = configure(decay_sweep_dq_tc<D>, L<D>::bytes, configured);
  CUtensorMap m[5];
  if (!err) err = tensor_maps(m, {q, k, v, d_o, g}, 4, D, t_len, rows);
  if (err) return err;
  decay_sweep_dq_tc<D><<<rows, kThreads, L<D>::bytes, stream>>>(
      m[0], m[1], m[2], m[3], m[4], static_cast<__nv_bfloat16*>(dq),
      static_cast<float*>(qdq), t_len, lo);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* g,
               const void* d_o, const void* qdq, void* dk, void* dv,
               void* dg, int rows, int t_len, float lo, cudaStream_t stream) {
  static bool configured = false;
  int err = configure(decay_sweep_dkv_tc<D>, L<D>::bytes, configured);
  CUtensorMap m[5];
  if (!err) err = tensor_maps(m, {q, k, v, d_o, g}, 4, D, t_len, rows);
  if (err) return err;
  decay_sweep_dkv_tc<D><<<rows, kThreads, L<D>::bytes, stream>>>(
      m[0], m[1], m[2], m[3], m[4], static_cast<const float*>(qdq),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      static_cast<float*>(dg), t_len, lo);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool EXCLUSIVE>
int launch_fwd(const void* q, const void* k, const void* v, const void* g,
               const void* u, void* o, void* s, int rows, int t_len,
               float lo, cudaStream_t stream) {
  static bool configured = false;
  int err = configure(decay_sweep_fwd_tc<D, EXCLUSIVE>, L<D>::bytes,
                      configured);
  CUtensorMap m[4];
  if (!err) err = tensor_maps(m, {q, k, v, g}, 3, D, t_len, rows);
  if (err) return err;
  decay_sweep_fwd_tc<D, EXCLUSIVE><<<rows, kThreads, L<D>::bytes, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(u),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(s), t_len, lo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

bool bad_shape(int rows, int t_len) { return rows <= 0 || t_len <= 0; }

}  // namespace

// Every pointer is a contiguous (rows, t, d) tensor on the current
// device: q, k, v, do and o, dv of one type, fp32 (bf16 == 0) or bf16
// (bf16 == 1); g, q⊙dq and dg fp32; dq and dk in the inputs' type; u (d,)
// fp32; s the (rows, d, d) fp32 final state. d in {16, 128}. The bf16
// routes (tensor cores) take 16-byte aligned inputs. Each returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for
// arguments it does not take, or 10000 + the driver's CUresult when a
// tensor map cannot be made.

// B8: o and the final state; inclusive, or exclusive with the bonus u.
// bf16 on the tensor cores, fp32 on FMAs.
extern "C" int gated_linear_attention_fwd(const void* q, const void* k,
                                          const void* v, const void* g,
                                          const void* u, void* o, void* s,
                                          int rows, int t, int d, int bf16,
                                          int exclusive, float min_log_decay,
                                          void* stream) {
  if (bad_shape(rows, t) || s == nullptr || (exclusive && u == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bf16) {
    if (tc::misaligned(q, k, v, g))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (d) {
      case 16:
        return exclusive ? tc::launch_fwd<16, true>(q, k, v, g, u, o, s, rows,
                                                    t, min_log_decay, st)
                         : tc::launch_fwd<16, false>(q, k, v, g, u, o, s,
                                                     rows, t, min_log_decay,
                                                     st);
      case 128:
        return exclusive ? tc::launch_fwd<128, true>(q, k, v, g, u, o, s,
                                                     rows, t, min_log_decay,
                                                     st)
                         : tc::launch_fwd<128, false>(q, k, v, g, u, o, s,
                                                      rows, t, min_log_decay,
                                                      st);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int mode = exclusive ? kFwdExclusive : kFwd;
  const auto sw = sweep(q, k, v, o, mode);
  return launch_d<false, true>(sw, sw, 1, g, u, s, rows, t, d, min_log_decay,
                               stream);
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
    switch (d) {
      case 16:
        return tc::launch_dq<16>(q, k, v, g, d_o, dq, qdq, rows, t,
                                 min_log_decay, st);
      case 128:
        return tc::launch_dq<128>(q, k, v, g, d_o, dq, qdq, rows, t,
                                  min_log_decay, st);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const auto sw = sweep(d_o, v, k, dq, kDq);
  return launch_d<false, false>(sw, sw, 1, g, nullptr, nullptr, rows, t, d,
                                min_log_decay, stream);
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
    switch (d) {
      case 16:
        return tc::launch_dkv<16>(q, k, v, g, d_o, qdq, dk, dv, dg, rows, t,
                                  min_log_decay, st);
      case 128:
        return tc::launch_dkv<128>(q, k, v, g, d_o, qdq, dk, dv, dg, rows,
                                   t, min_log_decay, st);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return launch_d<true, false>(sweep(v, d_o, q, dk, kDk),
                               sweep(k, q, d_o, dv, kDv), 2, g, nullptr,
                               nullptr, rows, t, d, min_log_decay, stream);
}
