// Chunked causal linear attention and its §3.3 recompute backward, for
// sm_90a.
//
// Replaces repro/kernels/linear_attention/kernel.py:
//   fwd (B2, _fwd_kernel)            -> linear_attention_fwd
//   bwd (B3, _dq_kernel)             -> linear_attention_bwd_dq
//   bwd (B3, _dkv_kernel)            -> linear_attention_bwd_dkv
//
// Nothing but q, k, v and do is read: no per-step state is stored, the
// paper's memory argument. Two bodies: fp32 on FMAs (B2, B3); bf16 on the
// tensor cores (B2, B3).
//
// 1. fp32 FMAs. All three are one sweep over the sequence, written once as
// sweep_kernel: with a running fp32 state S (D×D) that starts at zero, for
// each tile of TC tokens, in order (or in reverse),
//
//     out_tile = (A Bᵀ ⊙ M) C + A S ;   S += Bᵀ C
//
// with M the causal mask within the tile (row i sees rows j <= i). B2 is
// the sweep of (A, B, C) = (q, k, v) forward: o, and S emitted at the
// end as the final state. The Pallas backward's two sweeps are the same
// function of permuted inputs:
//   dq = (dO Vᵀ ⊙ M) K + dO Sᵀ            = sweep(do, v, k) forward
//        (its state is Σ v kᵀ = Sᵀ);
//   dk = (V dOᵀ ⊙ Mᵀ) Q + V Rᵀ            = sweep(v, do, q) in reverse
//   dv = (K Qᵀ ⊙ Mᵀ) dO + K R             = sweep(k, q, do) in reverse
//        (R = Σ_{later} q doᵀ; reversing the tokens turns Mᵀ into M).
// A reverse sweep walks the tiles last to first and loads each tile's
// rows in reverse, so the kernel body is the same; the loop in the block
// stands in for Pallas's reverse index_map. The dk/dv launch runs the dk
// and dv sweeps as one launch (blockIdx.z), each with its own copy of R.
// The tile TC (32 at D = 128) is not the wrapper's chunk: the function
// does not depend on the blocking, only the rounding does. A ragged last
// tile loads zero rows, which add nothing to S and are not stored. A
// block owns one (batch·head) row and one DS-column slice of the output
// and of S (DS = 64 at D = 128: two blocks per row); it recomputes the
// TC×TC scores for its slice. The block's S slice stays in shared memory
// across the loop, beside each tile of A, B and the C slice (77 KiB at
// D = 128, hence the opt-in above 48 KiB). The three products are
// register-tiled FMAs with every shared row padded by one word, so that
// the warps' reads do not conflict.
//
// 2. bf16 on the tensor cores: B2 (linear_sweep_fwd_tc) and B3
// (linear_sweep_dq_tc, linear_sweep_dkv_tc), B9's design
// (gated_linear_attention.cu) less the decay and less dg. B2 and the dq
// launch are one body, forward_sweep<D, FWD>, behind two kernels.
// - Grid: one block of two warpgroups per row, walking the row's 64-token
//   tiles (wgmma's M) forward (B2, dq) or last to first (dk/dv).
// - Loads: one thread issues TMA loads of a whole tile (k, v, q for B2,
//   q in do's slot; k, v, do for dq; all four for dk/dv) in 64-column
//   bf16 blocks with the 128-byte swizzle into a ring of two stages, the
//   next tile's during this tile's work; rows past T read as zeros,
//   which add nothing (T a multiple of the wrapper's chunk but not of 64
//   is covered).
// - Head dims: D is padded to DC 64-column blocks. D = 16 and 64 take one
//   block, 96, 112 and 128 two; columns past D read as zeros (the tensor
//   map is D wide: 224 bytes a row at D = 112, a multiple of TMA's 16),
//   so they add nothing to a score, an output or the state, and every
//   store (o, dq, dk, dv and the final state's rows and columns) skips
//   them. At D = 96 the padded block does a third more tensor-core work
//   than D needs, at D = 112 a seventh more.
// - Products: wgmma, bf16 operands, fp32 accumulators. The state (S =
//   Σ k vᵀ for B2 and dq, R = Σ_later q doᵀ for dk/dv, D×D fp32) lives in
//   the accumulator registers, its rows split over the two warpgroups;
//   each tile a bf16 copy goes to shared memory as the operand of the
//   inter-tile products. B2 and dq: each warpgroup owns 64 columns of the
//   output and computes the 64×64 score tile (Q Kᵀ, dO Vᵀ) itself, then
//   P V + Q S (B2: the copy read as it is) or P K + dO Sᵀ (dq: the copy
//   read transposed), with the state update Kᵀ V beside it. B2 writes the
//   final S in fp32 as (rows, Dk, Dv), staged through shared memory and
//   stored by whole rows. dk/dv: warpgroup 0 computes dk = (V dOᵀ ⊙ Mᵀ) Q
//   + V Rᵀ, warpgroup 1 dv = (K Qᵀ ⊙ Mᵀ) dO + K R, each from its own score
//   tile and the one state copy, with the update Qᵀ dO beside: R is built
//   once for both. The mask is applied to the score accumulators in
//   registers, and the score tile enters its product as one bf16 operand:
//   B9 splits it into hi + lo because its dg cancels, B2 and B3 have no
//   dg, and one part holds the normwise 8e-3 (two bf16 ulps of the
//   largest output) at every shape chip_smoke.py checks. B2's state is
//   exact to fp32 sums (k and v are bf16 already, with no decay to scale
//   them, so B8's hi + lo split of K̂ is not needed). Its o takes two bf16
//   roundings, of the score tile and of the state's copy, one part each,
//   with q and k positive (the model's elu1): on an H100 (chip_smoke.py
//   phase 2) max|Δo| is at most one bf16 ulp of the largest output at
//   every shape, 5.3e-3 of max|o| at T = 1,024 and 6.9e-3 at worst
//   (T = 75, where max|o| lies just above a power of two); max|ΔS| is
//   1.6e-6 of max|S| at most.
// - Keeping ptxas from serializing the wgmmas (its C7515/C7520 notes) and
//   from spilling, as B9 learnt: each wgmma group is straight-line code,
//   the score tile is a group of its own waited for before its mask writes
//   the next group's operands, the warpgroup index comes from a shuffle,
//   and offsets derived from the thread index are recomputed in each tile.
// - A barrier wait that lasts seconds traps, so that a lost phase fails
//   the launch instead of hanging the card.
//
// Bound. At the training main path's shape (B·H = 128 rows, T = 1,024,
// D = 128, bf16; one tensor 33.55 MB) bytes bind every kernel on the
// tensor cores. B2 reads q, k, v and writes o and S (142.6 MB): 42.6 µs
// at 3.35 TB/s; its scan-form 8.6 GFLOP take 8.7 µs on the bf16 tensor
// cores. B3 as a function reads q, k, v, do and writes dq, dk, dv
// (234.9 MB): 70.1 µs; its five scan-form products (21.5 GFLOP) take
// 21.7 µs on the bf16 tensor cores. Two sweeps each read their inputs:
// the dq launch moves 134.2 MB (40.1 µs), the dk/dv launch 201.3 MB
// (60.1 µs), 100.2 µs together.
//
// Accumulation is fp32; outputs are written in the input's type. Every
// launch runs on the caller's stream and allocates nothing.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "../../csrc/hopper.cuh"

namespace {

// Tiling per head dim D. Each product is an (M×N) tile over a thread
// grid MT×NT = kThreads; thread (ti, tj) holds rows ti + r·MT and columns
// tj + c·NT.
template <int D>
struct Cfg;

template <>
struct Cfg<128> {
  static constexpr int kThreads = 256;
  static constexpr int kTile = 32;   // TC: tokens per step
  static constexpr int kSlice = 64;  // DS: output / state columns per block
  static constexpr int kPm = 16, kPn = 16;  // scores  TC×TC
  static constexpr int kOm = 16, kOn = 16;  // output  TC×DS
  static constexpr int kSm = 32, kSn = 8;   // state   D×DS
};

// D = 96 and 64 (phi3-mini-3.8b, musicgen-large): 32-column slices, so
// three and two blocks per row
template <>
struct Cfg<96> {
  static constexpr int kThreads = 256;
  static constexpr int kTile = 32;
  static constexpr int kSlice = 32;
  static constexpr int kPm = 16, kPn = 16;
  static constexpr int kOm = 16, kOn = 16;
  static constexpr int kSm = 32, kSn = 8;
};

template <>
struct Cfg<64> {
  static constexpr int kThreads = 256;
  static constexpr int kTile = 32;
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
  static constexpr int kTile = 32;
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
  return 2 * C::kTile * (D + 1)               // A, B tiles
         + C::kTile * (C::kSlice + 1)         // C slice
         + C::kTile * (C::kTile + 1)          // scores
         + D * (C::kSlice + 1);               // state slice
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

struct Sweep {
  const float* a;
  const float* b;
  const float* c;
  float* out;
};

// grid (rows, D / DS, sweeps); block Cfg<D>::kThreads; dynamic shared
// memory smem_floats<D>() floats. blockIdx.z picks s0 or s1. With
// EMIT_STATE (B2 only), state receives the final S (rows, D, D) fp32.
// The three entry points are three instantiations, so a profile tells
// them apart: <false, true> B2, <false, false> dq, <true, false> dk/dv.
template <int D, bool REVERSE, bool EMIT_STATE>
__global__ void __launch_bounds__(Cfg<D>::kThreads)
sweep_kernel(Sweep s0, Sweep s1, float* __restrict__ state, int t_len) {
  using C = Cfg<D>;
  constexpr int kThreads = C::kThreads;
  constexpr int TC = C::kTile, DS = C::kSlice;
  constexpr int LA = D + 1, LC = DS + 1, LP = TC + 1;
  static_assert(D % DS == 0 && TC % C::kPm == 0 && TC % C::kPn == 0 &&
                    TC % C::kOm == 0 && DS % C::kOn == 0 &&
                    D % C::kSm == 0 && DS % C::kSn == 0,
                "tiling does not divide");
  static_assert(C::kPm * C::kPn == kThreads && C::kOm * C::kOn == kThreads &&
                    C::kSm * C::kSn == kThreads,
                "thread grids must cover the block");

  extern __shared__ float smem[];
  float* As = smem;
  float* Bs = As + TC * LA;
  float* Cs = Bs + TC * LA;
  float* Ps = Cs + TC * LC;
  float* Ss = Ps + TC * LP;

  const Sweep sw = blockIdx.z ? s1 : s0;
  const size_t row_off = static_cast<size_t>(blockIdx.x) * t_len * D;
  const float* __restrict__ A = sw.a + row_off;
  const float* __restrict__ B = sw.b + row_off;
  const float* __restrict__ Cg = sw.c + row_off;
  float* __restrict__ O = sw.out + row_off;
  const int col0 = blockIdx.y * DS;
  const int tid = threadIdx.x;

  for (int e = tid; e < D * LC; e += kThreads) Ss[e] = 0.f;

  const int n_tiles = (t_len + TC - 1) / TC;
  for (int step = 0; step < n_tiles; ++step) {
    const int tile = REVERSE ? n_tiles - 1 - step : step;
    const int tok0 = tile * TC;

    // -- load the tile (rows reversed in a reverse sweep) -----------------
    for (int e = tid; e < TC * D; e += kThreads) {
      const int r = e / D, col = e % D;
      const int tok = tok0 + (REVERSE ? TC - 1 - r : r);
      float av = 0.f, bv = 0.f;
      if (tok < t_len) {
        const size_t off = static_cast<size_t>(tok) * D + col;
        av = A[off];
        bv = B[off];
      }
      As[r * LA + col] = av;
      Bs[r * LA + col] = bv;
    }
    for (int e = tid; e < TC * DS; e += kThreads) {
      const int r = e / DS, col = e % DS;
      const int tok = tok0 + (REVERSE ? TC - 1 - r : r);
      Cs[r * LC + col] =
          tok < t_len ? Cg[static_cast<size_t>(tok) * D + col0 + col] : 0.f;
    }
    __syncthreads();

    // -- scores P = (A Bᵀ) ⊙ M ------------------------------------------
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
          Ps[i * LP + j] = j <= i ? acc[r][c] : 0.f;
        }
    }
    __syncthreads();

    // -- out = P C + A S (S before this tile's update) --------------------
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
          for (int c = 0; c < RN; ++c)
            O[static_cast<size_t>(tok) * D + col0 + tj + c * NT] =
                acc[r][c];
        }
      }
    }
    __syncthreads();

    // -- S += Bᵀ C ---------------------------------------------------------
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
        for (int c = 0; c < RN; ++c)
          Ss[(ti + r * MT) * LC + tj + c * NT] = acc[r][c];
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
int launch(Sweep s0, Sweep s1, int n_sweeps, float* state, int rows,
           int t_len, cudaStream_t stream) {
  using C = Cfg<D>;
  constexpr size_t kSmem = smem_floats<D>() * sizeof(float);
  auto kernel = sweep_kernel<D, REVERSE, EMIT_STATE>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(rows, D / C::kSlice, n_sweeps), block(C::kThreads);
  kernel<<<grid, block, kSmem, stream>>>(s0, s1, state, t_len);
  return static_cast<int>(cudaGetLastError());
}

template <bool REVERSE, bool EMIT_STATE>
int launch_d(Sweep s0, Sweep s1, int n_sweeps, float* state, int rows,
             int t_len, int d, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<16, REVERSE, EMIT_STATE>(s0, s1, n_sweeps, state, rows,
                                             t_len, stream);
    case 64:
      return launch<64, REVERSE, EMIT_STATE>(s0, s1, n_sweeps, state, rows,
                                             t_len, stream);
    case 96:
      return launch<96, REVERSE, EMIT_STATE>(s0, s1, n_sweeps, state, rows,
                                             t_len, stream);
    case 112:
      return launch<112, REVERSE, EMIT_STATE>(s0, s1, n_sweeps, state, rows,
                                              t_len, stream);
    case 128:
      return launch<128, REVERSE, EMIT_STATE>(s0, s1, n_sweeps, state, rows,
                                              t_len, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

Sweep sweep(const void* a, const void* b, const void* c, void* out) {
  return Sweep{static_cast<const float*>(a), static_cast<const float*>(b),
               static_cast<const float*>(c), static_cast<float*>(out)};
}

// ---------------------------------------------------------------------------
// B2 and B3 in bf16: tensor cores (see the header, body 2), on the TMA,
// mbarrier and wgmma helpers of kernels/csrc/hopper.cuh.
// ---------------------------------------------------------------------------
namespace tc {

// Shared memory, from a 1024-byte aligned base (the swizzle's period):
// two stages of {q, k, v, do: DC blocks of [64 tokens][64 bf16] each},
// every block as TMA writes it with the 128-byte swizzle (B2 loads q into
// do's slot, and B2 and the dq launch leave q's empty); the state's bf16
// copy, DC blocks of [DP rows][64 bf16], swizzled the same way; two
// mbarriers.
template <int D>
struct L {
  static constexpr int DC = (D + 63) / 64;     // 64-column bf16 blocks
  static constexpr int DP = 64 * DC;           // D padded to them
  static constexpr int tile = DC * kBlock;     // one tensor's tile
  static constexpr int q = 0, k = tile, v = 2 * tile, o = 3 * tile;
  static constexpr int stage = 4 * tile;
  static constexpr int x = 2 * stage;
  static constexpr int xblock = DP * kRowBytes;
  static constexpr int bars = x + DC * xblock;
  static constexpr int bytes = bars + 16 + 1024;
};

// The loads of one tile (its first token tok0) into a stage: k, v, the row
// operand into do's slot (do for the dk/dv and dq launches, q for B2) and,
// with Q, q (the dk/dv launch), in 64-column blocks; rows past T read as
// zeros
template <int D, bool Q>
__device__ __forceinline__ void load_tile(
    uint32_t stage, uint32_t bar, const CUtensorMap* tq,
    const CUtensorMap* tk, const CUtensorMap* tv, const CUtensorMap* to,
    int tok0, int row) {
  using S = L<D>;
  mbar_expect_tx(bar, (3 + Q) * S::tile);
#pragma unroll
  for (int cb = 0; cb < S::DC; ++cb) {
    if (Q) tma_load(stage + S::q + cb * kBlock, tq, bar, 64 * cb, tok0, row);
    tma_load(stage + S::k + cb * kBlock, tk, bar, 64 * cb, tok0, row);
    tma_load(stage + S::v + cb * kBlock, tv, bar, 64 * cb, tok0, row);
    tma_load(stage + S::o + cb * kBlock, to, bar, 64 * cb, tok0, row);
  }
}

// a warpgroup's 64-column slice of an output in the accumulator layout
// (rows r0 and r0 + 8, columns 8g + cl + e), in bf16, tokens < t_len
template <int D>
__device__ __forceinline__ void store_out(__nv_bfloat16* out,
                                          const float (&a)[32], int row,
                                          int t_len, int tok0, int col0,
                                          int r0, int cl) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int tok = tok0 + r0 + 8 * h;
    if (tok >= t_len) continue;
    const size_t off = (static_cast<size_t>(row) * t_len + tok) * D;
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const int c = col0 + 8 * g + cl;
      if (c >= D) continue;
      *reinterpret_cast<uint32_t*>(out + off + c) =
          pack_bf16(a[4 * g + 2 * h], a[4 * g + 2 * h + 1]);
    }
  }
}

// The forward sweep of B2 (FWD) and of B3's dq launch, one body: per
// 64-token tile, with S[dk][dv] = Σ k vᵀ over the earlier tiles,
//     B2:  o  = (Q Kᵀ ⊙ M) V + Q S      ;  S += Kᵀ V
//     dq:  dq = (dO Vᵀ ⊙ M) K + dO Sᵀ   ;  S += Kᵀ V
// and for B2 at the end the final S in fp32, (rows, D, D). The row operand
// A (q, or do) sits in do's slot; B2 reads the state's copy as it is, dq
// reads it transposed. Each choice between the two is an if constexpr, so
// every wgmma group stays straight-line code.
template <int D, bool FWD>
__device__ __forceinline__ void forward_sweep(
    const CUtensorMap* tk, const CUtensorMap* tv, const CUtensorMap* ta,
    __nv_bfloat16* __restrict__ out, float* __restrict__ state, int t_len) {
  using S = L<D>;
  constexpr int DC = S::DC;
  constexpr int SB = FWD ? S::k : S::v;   // the score tile's B: K, or V
  constexpr int PC = FWD ? S::v : S::k;   // P's right operand: V, or K
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sb = smem_raw + (base - raw);
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
  __syncthreads();
  if (tid == 0) load_tile<D, false>(base, bar0, nullptr, tk, tv, ta, 0, row);

  float x[DC][32];   // S rows 64·wg + (0..63) (wg < DC)
#pragma unroll
  for (int j = 0; j < DC; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) x[j][i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    // Offsets derived from the thread index are recomputed in each tile:
    // hoisted out of the loop, they would hold registers across it.
    int t = threadIdx.x;
    asm volatile("" : "+r"(t));
    const int r0 = (t % 128) / 32 * 16 + (t % 32) / 4, cl = 2 * (t % 4);
    if (tid == 0 && it + 1 < n_tiles)
      load_tile<D, false>(base + ((it + 1) & 1) * S::stage,
                          bar0 + 8 * ((it + 1) & 1), nullptr, tk, tv, ta,
                          (it + 1) * kTile, row);
    const uint32_t st = base + (it & 1) * S::stage;
    mbar_wait(bar0 + 8 * (it & 1), (it >> 1) & 1);
    if (wg < DC) store_state(sb + S::x, S::xblock, x, wg, r0, cl);
    fence_async();
    __syncthreads();

    if (wg < DC) {
      float sc[32], acc[32];
      uint32_t p[4][4];
      // the score tile (Q Kᵀ, dO Vᵀ), alone: no register of a later
      // product is written while a wgmma group is open (ptxas would
      // serialize them)
      fence_regs(sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * DC; ++kk)
        wgmma_ss<0, 0>(sc, kdesc(st + S::o, kBlock, kk),
                       kdesc(st + SB, kBlock, kk), kk > 0);
      wg_commit();
      fence_regs(sc);
      wg_wait<0>();
      fence_regs(sc);
      mask_pack<true>(sc, p, r0, cl);
      // the output's 64 columns of this warpgroup, P V + Q S (S's copy
      // read as Dk rows by Dv columns) or P K + dO Sᵀ; beside it the
      // state update S += Kᵀ V (the copy in shared memory is read, the
      // registers are updated)
      fence_regs(acc);
      fence_regs(x);
      fence_regs(p);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc, p[kk], mdesc(st + PC + wg * kBlock, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4 * DC; ++kk) {
        if constexpr (FWD)
          wgmma_ss<0, 1>(acc, kdesc(st + S::o, kBlock, kk),
                         mdesc(base + S::x + wg * S::xblock, kk), 1);
        else
          wgmma_ss<0, 0>(acc, kdesc(st + S::o, kBlock, kk),
                         kdesc(base + S::x + 64 * wg * kRowBytes, S::xblock,
                               kk),
                         1);
      }
#pragma unroll
      for (int j = 0; j < DC; ++j)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<1, 1>(x[j], mdesc(st + S::k + wg * kBlock, kk),
                         mdesc(st + S::v + j * kBlock, kk), 1);
      wg_commit();
      fence_regs(acc);
      fence_regs(x);
      fence_regs(p);
      wg_wait<0>();
      fence_regs(acc);
      fence_regs(x);
      store_out<D>(out, acc, row, t_len, it * kTile, 64 * wg, r0, cl);
    }
    fence_async();
    __syncthreads();   // the stage and the state copy are free
  }

  if constexpr (FWD) {
    // The final state, fp32: staged in the free stages (rows padded to
    // D + 8 floats), then written by whole rows. Stored straight from the
    // accumulator layout, each warp store would span 8 rows in 32-byte
    // pieces, which costs about 5 µs more (PERF.md §6).
    constexpr int LS = D + 8;
    static_assert(D * LS * 4 <= 2 * S::stage, "the stages hold the state");
    float* const ss = reinterpret_cast<float*>(sb);
    if (wg < DC) {
      const int r0 = (tid % 128) / 32 * 16 + (tid % 32) / 4,
                cl = 2 * (tid % 4);
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
            *reinterpret_cast<float2*>(ss + r * LS + c) =
                make_float2(x[j][4 * g + 2 * h], x[j][4 * g + 2 * h + 1]);
          }
        }
    }
    __syncthreads();
    float* const s_row = state + static_cast<size_t>(row) * D * D;
    for (int e = tid; e < D * D / 4; e += kThreads) {
      const int r = e / (D / 4), c = 4 * (e % (D / 4));
      *reinterpret_cast<float4*>(s_row + r * D + c) =
          *reinterpret_cast<const float4*>(ss + r * LS + c);
    }
  }
}

// B2: o and the final state S. grid (rows); block kThreads; dynamic shared
// memory L<D>::bytes. Tensor maps (D, T, rows) with boxes (64, 64, 1) for
// q, k, v.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
linear_sweep_fwd_tc(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ state,
                    int t_len) {
  forward_sweep<D, true>(&tk, &tv, &tq, o, state, t_len);
}

// B3's forward sweep: dq. Launch as linear_sweep_fwd_tc, with maps for k,
// v, do.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
linear_sweep_dq_tc(const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap to,
                   __nv_bfloat16* __restrict__ dq, int t_len) {
  forward_sweep<D, false>(&tk, &tv, &to, dq, nullptr, t_len);
}

// The dk/dv launch's products for warpgroup WG, straight-line (a branch
// inside an open wgmma group makes ptxas serialize it): per 64 columns j,
// dk = P Q + V Xᵀ (WG 0) or dv = P dO + K X (WG 1), with P this
// warpgroup's masked score tile; beside them the update X += Qᵀ dO of its
// state rows.
template <int D, int WG>
__device__ __forceinline__ void dkv_products(float (&acc)[L<D>::DC][32],
                                             float (&x)[L<D>::DC][32],
                                             uint32_t (&p)[4][4],
                                             uint32_t st, uint32_t base) {
  using S = L<D>;
  constexpr int DC = S::DC;
  const uint32_t rb = st + (WG ? S::o : S::q);
  fence_regs(acc);
  fence_regs(x);
  fence_regs(p);
  wg_fence();
#pragma unroll
  for (int j = 0; j < DC; ++j) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc[j], p[kk], mdesc(rb + j * kBlock, kk), kk > 0);
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
  fence_regs(p);
  wg_wait<0>();
  fence_regs(acc);
  fence_regs(x);
}

// B3's reverse sweep, tiles last to first: per tile, with X = R[dk][dv] =
// Σ q doᵀ over the later tiles,
//     dk = (V dOᵀ ⊙ Mᵀ) Q + V Xᵀ   (warpgroup 0)
//     dv = (K Qᵀ ⊙ Mᵀ) dO + K X    (warpgroup 1) ;  X += Qᵀ dO
// Launch as linear_sweep_fwd_tc, with maps for q, k, v, do.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
linear_sweep_dkv_tc(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap to,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int t_len) {
  using S = L<D>;
  constexpr int DC = S::DC;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sb = smem_raw + (base - raw);
  const uint32_t bar0 = base + S::bars;
  // the warpgroup, from lane 0 (see forward_sweep)
  const int tid = threadIdx.x,
            wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int row = blockIdx.x;
  const int n_tiles = (t_len + kTile - 1) / kTile;

  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    load_tile<D, true>(base, bar0, &tq, &tk, &tv, &to, (n_tiles - 1) * kTile,
                       row);

  float x[DC][32];   // R rows 64·wg + (0..63) (wg < DC)
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
      load_tile<D, true>(base + ((it + 1) & 1) * S::stage,
                         bar0 + 8 * ((it + 1) & 1), &tq, &tk, &tv, &to,
                         (n_tiles - 2 - it) * kTile, row);
    const uint32_t st = base + (it & 1) * S::stage;
    const int tok0 = (n_tiles - 1 - it) * kTile;
    mbar_wait(bar0 + 8 * (it & 1), (it >> 1) & 1);
    if (wg < DC) store_state(sb + S::x, S::xblock, x, wg, r0, cl);
    fence_async();
    __syncthreads();

    float acc[DC][32];
    {
      float sc[32];
      uint32_t p[4][4];
      // this warpgroup's score tile, alone: V dOᵀ for dk, K Qᵀ for dv
      const uint32_t sa = st + (wg ? S::k : S::v);
      const uint32_t sbb = st + (wg ? S::q : S::o);
      fence_regs(sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * DC; ++kk)
        wgmma_ss<0, 0>(sc, kdesc(sa, kBlock, kk), kdesc(sbb, kBlock, kk),
                       kk > 0);
      wg_commit();
      fence_regs(sc);
      wg_wait<0>();
      fence_regs(sc);
      mask_pack<false>(sc, p, r0, cl);
      if (wg == 0)
        dkv_products<D, 0>(acc, x, p, st, base);
      else
        dkv_products<D, 1>(acc, x, p, st, base);
    }
    __nv_bfloat16* const out = wg ? dv : dk;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      store_out<D>(out, acc[j], row, t_len, tok0, 64 * j, r0, cl);
    fence_async();
    __syncthreads();   // the stage and the state copy are free
  }
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* state, int rows, int t_len, cudaStream_t stream) {
  static bool configured = false;
  int err = configure(linear_sweep_fwd_tc<D>, L<D>::bytes, configured);
  CUtensorMap m[3];
  if (!err) err = tensor_maps(m, {q, k, v}, 3, D, t_len, rows);
  if (err) return err;
  linear_sweep_fwd_tc<D><<<rows, kThreads, L<D>::bytes, stream>>>(
      m[0], m[1], m[2], static_cast<__nv_bfloat16*>(o), state, t_len);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* k, const void* v, const void* d_o, void* dq,
              int rows, int t_len, cudaStream_t stream) {
  static bool configured = false;
  int err = configure(linear_sweep_dq_tc<D>, L<D>::bytes, configured);
  CUtensorMap m[3];
  if (!err) err = tensor_maps(m, {k, v, d_o}, 3, D, t_len, rows);
  if (err) return err;
  linear_sweep_dq_tc<D><<<rows, kThreads, L<D>::bytes, stream>>>(
      m[0], m[1], m[2], static_cast<__nv_bfloat16*>(dq), t_len);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* d_o,
               void* dk, void* dv, int rows, int t_len, cudaStream_t stream) {
  static bool configured = false;
  int err = configure(linear_sweep_dkv_tc<D>, L<D>::bytes, configured);
  CUtensorMap m[4];
  if (!err) err = tensor_maps(m, {q, k, v, d_o}, 4, D, t_len, rows);
  if (err) return err;
  linear_sweep_dkv_tc<D><<<rows, kThreads, L<D>::bytes, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), t_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

bool bad_shape(int rows, int t_len) { return rows <= 0 || t_len <= 0; }

}  // namespace

// Every pointer is a contiguous (rows, t, d) tensor of one type, fp32
// (bf16 == 0) or bf16 (bf16 == 1), on the current device, except s: the
// (rows, d, d) fp32 final state. d in {16, 64, 96, 112, 128}. Each returns
// cudaGetLastError() after the launch (or cudaErrorInvalidValue).

// B2: o = chunked causal linear attention of (q, k, v); s = Σ k vᵀ; bf16
// on the tensor cores, fp32 on FMAs.
extern "C" int linear_attention_fwd(const void* q, const void* k,
                                    const void* v, void* o, void* s,
                                    int rows, int t, int d, int bf16,
                                    void* stream) {
  if (bad_shape(rows, t) || s == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sf = static_cast<float*>(s);
  if (bf16) {
    if (tc::misaligned(q, k, v))
      return static_cast<int>(cudaErrorInvalidValue);
    switch (d) {
      case 16:
        return tc::launch_fwd<16>(q, k, v, o, sf, rows, t, st);
      case 64:
        return tc::launch_fwd<64>(q, k, v, o, sf, rows, t, st);
      case 96:
        return tc::launch_fwd<96>(q, k, v, o, sf, rows, t, st);
      case 112:
        return tc::launch_fwd<112>(q, k, v, o, sf, rows, t, st);
      case 128:
        return tc::launch_fwd<128>(q, k, v, o, sf, rows, t, st);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const auto sw = sweep(q, k, v, o);
  return launch_d<false, true>(sw, sw, 1, sf, rows, t, d, st);
}

// B3, forward sweep: dq = (dO Vᵀ ⊙ M) K + dO Sᵀ; bf16 on the tensor
// cores, fp32 on FMAs.
extern "C" int linear_attention_bwd_dq(const void* k, const void* v,
                                       const void* d_o, void* dq, int rows,
                                       int t, int d, int bf16,
                                       void* stream) {
  if (bad_shape(rows, t)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (tc::misaligned(k, v, d_o))
      return static_cast<int>(cudaErrorInvalidValue);
    switch (d) {
      case 16:
        return tc::launch_dq<16>(k, v, d_o, dq, rows, t, st);
      case 64:
        return tc::launch_dq<64>(k, v, d_o, dq, rows, t, st);
      case 96:
        return tc::launch_dq<96>(k, v, d_o, dq, rows, t, st);
      case 112:
        return tc::launch_dq<112>(k, v, d_o, dq, rows, t, st);
      case 128:
        return tc::launch_dq<128>(k, v, d_o, dq, rows, t, st);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const auto sw = sweep(d_o, v, k, dq);
  return launch_d<false, false>(sw, sw, 1, nullptr, rows, t, d, st);
}

// B3, reverse sweep: dk = (V dOᵀ ⊙ Mᵀ) Q + V Rᵀ and
// dv = (K Qᵀ ⊙ Mᵀ) dO + K R, one launch; bf16 on the tensor cores, fp32 on
// FMAs.
extern "C" int linear_attention_bwd_dkv(const void* q, const void* k,
                                        const void* v, const void* d_o,
                                        void* dk, void* dv, int rows, int t,
                                        int d, int bf16, void* stream) {
  if (bad_shape(rows, t)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (tc::misaligned(q, k, v, d_o))
      return static_cast<int>(cudaErrorInvalidValue);
    switch (d) {
      case 16:
        return tc::launch_dkv<16>(q, k, v, d_o, dk, dv, rows, t, st);
      case 64:
        return tc::launch_dkv<64>(q, k, v, d_o, dk, dv, rows, t, st);
      case 96:
        return tc::launch_dkv<96>(q, k, v, d_o, dk, dv, rows, t, st);
      case 112:
        return tc::launch_dkv<112>(q, k, v, d_o, dk, dv, rows, t, st);
      case 128:
        return tc::launch_dkv<128>(q, k, v, d_o, dk, dv, rows, t, st);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return launch_d<true, false>(sweep(v, d_o, q, dk), sweep(k, q, d_o, dv), 2,
                               nullptr, rows, t, d, st);
}
