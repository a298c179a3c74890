// Chunked causal linear attention and its §3.3 recompute backward, for
// sm_90a.
//
// Replaces repro/kernels/linear_attention/kernel.py:
//   fwd (B2, _fwd_kernel)            -> linear_attention_fwd
//   bwd (B3, _dq_kernel)             -> linear_attention_bwd_dq
//   bwd (B3, _dkv_kernel)            -> linear_attention_bwd_dkv
//
// All three are one sweep over the sequence, written once as
// sweep_kernel: with a running fp32 state S (D×D) that starts at zero,
// for each tile of TC tokens, in order (or in reverse),
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
// stands in for Pallas's reverse index_map. linear_attention_bwd_dkv
// runs the dk and dv sweeps as one launch (blockIdx.z), each with its
// own copy of R: one product more per tile than _dkv_kernel's seven,
// for one kernel body instead of three. Nothing but q, k, v and do is
// read: no per-step state is stored, the paper's memory argument.
//
// The tile TC (32 at D = 128) is not the wrapper's chunk: the function
// does not depend on the blocking, only the rounding does. A ragged last
// tile loads zero rows, which add nothing to S and are not stored.
//
// Bound: operations. At the training main path's shape (B·H = 128 rows,
// T = 1,024, D = 128, bf16) B2 needs the scan form's 4·T·D² per row,
// 8.6 GFLOP, against 143 MB: 128 µs at the fp32 CUDA-core rate
// (67 TFLOP/s), 43 µs at 3.35 TB/s. This chunked form does more: the
// tile's score products, recomputed by each column slice.
//
// Design: a simple, correct kernel on the fp32 CUDA cores (no tensor
// cores, TMA or pipelining yet). A block owns one (batch·head) row and
// one DS-column slice of the output and of S (DS = 64 at D = 128: two
// blocks per row, so 256 blocks at the main path's 128 rows, two per
// SM); it recomputes the TC×TC scores for its slice. The block's S slice
// (D×DS fp32, 32 KiB) stays in shared memory across the loop; each tile
// of A, B and the C slice is converted to fp32 in shared memory (77 KiB
// in all at D = 128, hence the opt-in above 48 KiB). The three products
// are register-tiled FMAs with rows and columns interleaved over the
// threads and every shared row padded by one word, so that the warps'
// reads do not conflict. Accumulation is fp32; outputs are written in
// the input's type. Launches on the caller's stream, allocates nothing.

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

template <typename T>
struct Sweep {
  const T* a;
  const T* b;
  const T* c;
  T* out;
};

// grid (rows, D / DS, sweeps); block Cfg<D>::kThreads; dynamic shared
// memory smem_floats<D>() floats. blockIdx.z picks s0 or s1. With
// EMIT_STATE (B2 only), state receives the final S (rows, D, D) fp32.
// The three entry points are three instantiations, so a profile tells
// them apart: <false, true> B2, <false, false> dq, <true, false> dk/dv.
template <typename T, int D, bool REVERSE, bool EMIT_STATE>
__global__ void __launch_bounds__(Cfg<D>::kThreads)
sweep_kernel(Sweep<T> s0, Sweep<T> s1, float* __restrict__ state,
             int t_len) {
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

  const Sweep<T> sw = blockIdx.z ? s1 : s0;
  const size_t row_off = static_cast<size_t>(blockIdx.x) * t_len * D;
  const T* __restrict__ A = sw.a + row_off;
  const T* __restrict__ B = sw.b + row_off;
  const T* __restrict__ Cg = sw.c + row_off;
  T* __restrict__ O = sw.out + row_off;
  const int col0 = blockIdx.y * DS;
  const int tid = threadIdx.x;

  for (int e = tid; e < D * LC; e += kThreads) Ss[e] = 0.f;

  const int n_tiles = (t_len + TC - 1) / TC;
  for (int step = 0; step < n_tiles; ++step) {
    const int tile = REVERSE ? n_tiles - 1 - step : step;
    const int tok0 = tile * TC;

    // -- load the tile (rows reversed in a reverse sweep), as fp32 -------
    for (int e = tid; e < TC * D; e += kThreads) {
      const int r = e / D, col = e % D;
      const int tok = tok0 + (REVERSE ? TC - 1 - r : r);
      float av = 0.f, bv = 0.f;
      if (tok < t_len) {
        const size_t off = static_cast<size_t>(tok) * D + col;
        av = to_float(A[off]);
        bv = to_float(B[off]);
      }
      As[r * LA + col] = av;
      Bs[r * LA + col] = bv;
    }
    for (int e = tid; e < TC * DS; e += kThreads) {
      const int r = e / DS, col = e % DS;
      const int tok = tok0 + (REVERSE ? TC - 1 - r : r);
      Cs[r * LC + col] =
          tok < t_len ? to_float(Cg[static_cast<size_t>(tok) * D + col0 + col])
                      : 0.f;
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
                from_float<T>(acc[r][c]);
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

template <typename T, int D, bool REVERSE, bool EMIT_STATE>
int launch(Sweep<T> s0, Sweep<T> s1, int n_sweeps, float* state, int rows,
           int t_len, cudaStream_t stream) {
  using C = Cfg<D>;
  constexpr size_t kSmem = smem_floats<D>() * sizeof(float);
  auto kernel = sweep_kernel<T, D, REVERSE, EMIT_STATE>;
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

template <typename T, bool REVERSE, bool EMIT_STATE>
int launch_d(Sweep<T> s0, Sweep<T> s1, int n_sweeps, float* state, int rows,
             int t_len, int d, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16, REVERSE, EMIT_STATE>(s0, s1, n_sweeps, state,
                                                rows, t_len, stream);
    case 128:
      return launch<T, 128, REVERSE, EMIT_STATE>(s0, s1, n_sweeps, state,
                                                 rows, t_len, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
Sweep<T> sweep(const void* a, const void* b, const void* c, void* out) {
  return Sweep<T>{static_cast<const T*>(a), static_cast<const T*>(b),
                  static_cast<const T*>(c), static_cast<T*>(out)};
}

bool bad_shape(int rows, int t_len) { return rows <= 0 || t_len <= 0; }

}  // namespace

// Every pointer is a contiguous (rows, t, d) tensor of one type, fp32
// (bf16 == 0) or bf16 (bf16 == 1), on the current device, except s: the
// (rows, d, d) fp32 final state. d in {16, 128}. Each returns
// cudaGetLastError() after the launch (or cudaErrorInvalidValue).

// B2: o = chunked causal linear attention of (q, k, v); s = Σ k vᵀ.
extern "C" int linear_attention_fwd(const void* q, const void* k,
                                    const void* v, void* o, void* s,
                                    int rows, int t, int d, int bf16,
                                    void* stream) {
  if (bad_shape(rows, t) || s == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sf = static_cast<float*>(s);
  if (bf16) {
    const auto sw = sweep<__nv_bfloat16>(q, k, v, o);
    return launch_d<__nv_bfloat16, false, true>(sw, sw, 1, sf, rows, t, d,
                                                st);
  }
  const auto sw = sweep<float>(q, k, v, o);
  return launch_d<float, false, true>(sw, sw, 1, sf, rows, t, d, st);
}

// B3, forward sweep: dq = (dO Vᵀ ⊙ M) K + dO Sᵀ.
extern "C" int linear_attention_bwd_dq(const void* k, const void* v,
                                       const void* d_o, void* dq, int rows,
                                       int t, int d, int bf16,
                                       void* stream) {
  if (bad_shape(rows, t)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    const auto sw = sweep<__nv_bfloat16>(d_o, v, k, dq);
    return launch_d<__nv_bfloat16, false, false>(sw, sw, 1, nullptr, rows,
                                                 t, d, st);
  }
  const auto sw = sweep<float>(d_o, v, k, dq);
  return launch_d<float, false, false>(sw, sw, 1, nullptr, rows, t, d, st);
}

// B3, reverse sweep: dk = (V dOᵀ ⊙ Mᵀ) Q + V Rᵀ and
// dv = (K Qᵀ ⊙ Mᵀ) dO + K R, one launch.
extern "C" int linear_attention_bwd_dkv(const void* q, const void* k,
                                        const void* v, const void* d_o,
                                        void* dk, void* dv, int rows, int t,
                                        int d, int bf16, void* stream) {
  if (bad_shape(rows, t)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch_d<__nv_bfloat16, true, false>(
        sweep<__nv_bfloat16>(v, d_o, q, dk),
        sweep<__nv_bfloat16>(k, q, d_o, dv), 2, nullptr, rows, t, d, st);
  }
  return launch_d<float, true, false>(sweep<float>(v, d_o, q, dk),
                               sweep<float>(k, q, d_o, dv), 2, nullptr, rows,
                               t, d, st);
}
