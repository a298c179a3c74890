// Chunked gated (decay) linear attention and its recompute backward, for
// sm_90a.
//
// Replaces repro/kernels/gated_linear_attention/kernel.py:
//   fwd (B8, _fwd_kernel)            -> gated_linear_attention_fwd
//   bwd (B9, _dq_kernel)             -> gated_linear_attention_bwd_dq
//   bwd (B9, _dkv_kernel)            -> gated_linear_attention_bwd_dkv
// (bwd's dg epilogue, reverse-cumsum(q⊙dq − k⊙dk), stays in PyTorch, as
// JAX computes it outside the pallas_call.)
//
// The paper's §4 decay form, per (batch·head) row: with a_t = exp(g_t),
// g clamped to [min_log_decay, 0],
//     S_t = diag(a_t) S_{t-1} + k_t v_tᵀ ;   o_t = S_tᵀ q_t   (inclusive)
// or o_t = (S_{t-1} + diag(u) k_t v_tᵀ)ᵀ q_t (exclusive + u, RWKV-6).
//
// All four sweeps are one kernel body, B2/B3's sweep with decay factors:
// a running fp32 state X (D×DS) from zero, for each tile of TC tokens
// with b the cumulative clamped log-decay FROM THE TILE'S START,
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
// tile's rows reversed, which turns Mᵀ into M, as in B3. dk and dv share
// one launch (blockIdx.z). Only q, k, v, g and do are read: no state is
// stored, the paper's memory argument.
//
// Why tiles of at most 32 tokens: with g at its clamp (−1), b over a
// 128-token chunk reaches −128 and exp(−b) passes fp32's limit (about
// e^88.7); the Pallas bodies and the chunk-128 plain versions then give
// inf and NaN. Here |b| ≤ TC ≤ 32, so every factor lies in
// [e^-32, e^32], and the carried state is only ever multiplied by
// e^{btot} ≤ 1: the kernels stay finite and agree with the per-token
// recurrence. The function does not depend on the blocking otherwise.
// A ragged last tile loads zero rows and log-decay 0 (JAX pads g with 0),
// which add nothing and decay nothing.
//
// Bound: operations. At the training main path's shape (128 rows,
// T = 1,024, D = 128, bf16 q/k/v, fp32 g) the scan form needs 2·T·D² per
// row for each state update and product: two for o and dq (8.6 GFLOP,
// 128 µs at the fp32 CUDA-core rate of 67 TFLOP/s), three for dk/dv
// (192 µs); the bytes (201–268 MB with the fp32 g) take 60–80 µs at
// 3.35 TB/s. The tiled form does more: the score products, recomputed
// by each column slice, and the exps.
//
// Design: B2/B3's simple, correct layout on the fp32 CUDA cores (no
// tensor cores, TMA or pipelining yet). A block owns one row and one
// DS-column slice (DS = 64 at D = 128: 256 blocks at 128 rows). The
// state slice (32 KiB) stays in shared memory across the loop; each tile
// stages g's cumulative sum, the scaled A and B, and the C slice in fp32
// (96 KiB in all at D = 128, two blocks per SM). Products are
// register-tiled FMAs over threads with rows and columns interleaved and
// shared rows padded by one word. Accumulation is fp32; o and dv are
// written in the input's type, dq and dk in fp32 for the dg epilogue.
// Launches on the caller's stream, allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

template <typename T>
struct Sweep {
  const T* a;
  const T* b;
  const T* c;
  T* out;         // o (kFwd, kFwdExclusive) or dv (kDv), in T
  float* out_f;   // dq (kDq) or dk (kDk), fp32
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
template <typename T, int D, bool REVERSE, bool EMIT_STATE>
__global__ void __launch_bounds__(Cfg<D>::kThreads)
decay_sweep(Sweep<T> s0, Sweep<T> s1, const float* __restrict__ g,
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

  const Sweep<T> sw = blockIdx.z ? s1 : s0;
  const int mode = sw.mode;
  const size_t row_off = static_cast<size_t>(blockIdx.x) * t_len * D;
  const T* __restrict__ A = sw.a + row_off;
  const T* __restrict__ B = sw.b + row_off;
  const T* __restrict__ Cg = sw.c + row_off;
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
        av = to_float(A[off]);
        bv = to_float(B[off]);
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
          ? to_float(Cg[static_cast<size_t>(tok) * D + col0 + col])
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
            if (mode == kDq) {
              sw.out_f[row_off + off] = acc[r][c] * expf(Gs[i * LA + col]);
            } else if (mode == kDk) {
              sw.out_f[row_off + off] = acc[r][c] * expf(-Gs[i * LA + col]);
            } else {
              sw.out[row_off + off] = from_float<T>(acc[r][c]);
            }
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

template <typename T, int D, bool REVERSE, bool EMIT_STATE>
int launch(Sweep<T> s0, Sweep<T> s1, int n_sweeps, const float* g,
           const float* u, float* state, int rows, int t_len,
           float min_log_decay, cudaStream_t stream) {
  using C = Cfg<D>;
  constexpr size_t kSmem = smem_floats<D>() * sizeof(float);
  auto kernel = decay_sweep<T, D, REVERSE, EMIT_STATE>;
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

template <typename T, bool REVERSE, bool EMIT_STATE>
int launch_d(Sweep<T> s0, Sweep<T> s1, int n_sweeps, const void* g,
             const void* u, void* state, int rows, int t_len, int d,
             float min_log_decay, void* stream) {
  const float* gf = static_cast<const float*>(g);
  const float* uf = static_cast<const float*>(u);
  float* sf = static_cast<float*>(state);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return launch<T, 16, REVERSE, EMIT_STATE>(s0, s1, n_sweeps, gf, uf, sf,
                                                rows, t_len, min_log_decay,
                                                st);
    case 128:
      return launch<T, 128, REVERSE, EMIT_STATE>(s0, s1, n_sweeps, gf, uf,
                                                 sf, rows, t_len,
                                                 min_log_decay, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
Sweep<T> sweep(const void* a, const void* b, const void* c, void* out,
               int mode) {
  const bool f32_out = mode == kDq || mode == kDk;
  return Sweep<T>{static_cast<const T*>(a), static_cast<const T*>(b),
                  static_cast<const T*>(c),
                  f32_out ? nullptr : static_cast<T*>(out),
                  f32_out ? static_cast<float*>(out) : nullptr, mode};
}

bool bad_shape(int rows, int t_len) { return rows <= 0 || t_len <= 0; }

}  // namespace

// Every pointer is a contiguous (rows, t, d) tensor on the current
// device: q, k, v, do and o, dv of one type, fp32 (bf16 == 0) or bf16
// (bf16 == 1); g, dq and dk fp32; u (d,) fp32; s the (rows, d, d) fp32
// final state. d in {16, 128}. Each returns cudaGetLastError() after the
// launch (or cudaErrorInvalidValue).

// B8: o and the final state; inclusive, or exclusive with the bonus u.
extern "C" int gated_linear_attention_fwd(const void* q, const void* k,
                                          const void* v, const void* g,
                                          const void* u, void* o, void* s,
                                          int rows, int t, int d, int bf16,
                                          int exclusive, float min_log_decay,
                                          void* stream) {
  if (bad_shape(rows, t) || s == nullptr || (exclusive && u == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int mode = exclusive ? kFwdExclusive : kFwd;
  if (bf16) {
    const auto sw = sweep<__nv_bfloat16>(q, k, v, o, mode);
    return launch_d<__nv_bfloat16, false, true>(sw, sw, 1, g, u, s, rows, t,
                                                d, min_log_decay, stream);
  }
  const auto sw = sweep<float>(q, k, v, o, mode);
  return launch_d<float, false, true>(sw, sw, 1, g, u, s, rows, t, d,
                                      min_log_decay, stream);
}

// B9, forward sweep: dq = e^{b} ⊙ [(dO Vᵀ ⊙ M) K̂ + dO Sᵀ], fp32.
extern "C" int gated_linear_attention_bwd_dq(const void* k, const void* v,
                                             const void* g, const void* d_o,
                                             void* dq, int rows, int t,
                                             int d, int bf16,
                                             float min_log_decay,
                                             void* stream) {
  if (bad_shape(rows, t)) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16) {
    const auto sw = sweep<__nv_bfloat16>(d_o, v, k, dq, kDq);
    return launch_d<__nv_bfloat16, false, false>(
        sw, sw, 1, g, nullptr, nullptr, rows, t, d, min_log_decay, stream);
  }
  const auto sw = sweep<float>(d_o, v, k, dq, kDq);
  return launch_d<float, false, false>(sw, sw, 1, g, nullptr, nullptr, rows,
                                       t, d, min_log_decay, stream);
}

// B9, reverse sweep: dk (fp32) = e^{-b} ⊙ [(V dOᵀ ⊙ Mᵀ) Q̂ + V R'ᵀ] and
// dv = (K̂ Q̂ᵀ ⊙ Mᵀ) dO + K̂ R', one launch.
extern "C" int gated_linear_attention_bwd_dkv(const void* q, const void* k,
                                              const void* v, const void* g,
                                              const void* d_o, void* dk,
                                              void* dv, int rows, int t,
                                              int d, int bf16,
                                              float min_log_decay,
                                              void* stream) {
  if (bad_shape(rows, t)) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16) {
    return launch_d<__nv_bfloat16, true, false>(
        sweep<__nv_bfloat16>(v, d_o, q, dk, kDk),
        sweep<__nv_bfloat16>(k, q, d_o, dv, kDv), 2, g, nullptr, nullptr,
        rows, t, d, min_log_decay, stream);
  }
  return launch_d<float, true, false>(sweep<float>(v, d_o, q, dk, kDk),
                                      sweep<float>(k, q, d_o, dv, kDv), 2, g,
                                      nullptr, nullptr, rows, t, d,
                                      min_log_decay, stream);
}
