// Causal flash attention, forward, for sm_90a.
//
// Replaces repro/kernels/flash_attention/kernel.py:
//   fwd (B10, _fwd_kernel; pallas_call at :79) -> flash_attention_fwd
//
// For each (batch·head) row, query i attends key j iff j <= i + t_off
// and j < s_real; o_i = Σ_j softmax_j(q_i·k_j·scale) v_j, with the
// online softmax of the Pallas body: running (m, l, acc) in fp32 per
// query, masked scores set to NEG_INF = -1e30 (not -inf), a key tile's
// scores s folded in as
//     m' = max(m, max_j s_j);  p_j = exp(s_j - m');  a = exp(m - m');
//     l' = a·l + Σ_j p_j;      acc' = a·acc + Σ_j p_j v_j,
// and o = acc / l (l = 0 taken as 1) written in the input's type.
//
// The Pallas grid visits every key tile of every query tile. This kernel
// stops after the tile that holds key min(last query + t_off, s_real-1):
// the tiles after it are masked for every query of the block. Skipping
// them gives the same numbers, provided each query has seen a visible
// key before its first fully masked tile: then m is a real score, the
// masked p = exp(-1e30 - m) is exactly 0 in fp32 and a = exp(0) = 1.
// Key 0 lies in the first tile and is visible to every query when
// t_off >= 0 and s_real >= 1, which the entry point requires. (A query
// that sees no key at all would differ: under the Pallas grid its m
// stays -1e30, every masked p is 1, and it returns the mean of v.)
//
// Bound: operations. At the prefill main path's shape (B·H = 128 rows,
// T = S = 512, D = 128, bf16) the causal pairs need 2·D operations each
// for q·k and 2·D for p·v: 8.61 GFLOP, 128.5 µs at the fp32 CUDA-core
// rate (67 TFLOP/s), against 67 MB of q, k, v and o (20 µs at
// 3.35 TB/s). This kernel does the work of the live 64×64 tiles, 12%
// more than the causal pairs at that shape (36 of 64 tile pairs, where
// the Pallas grid's 128×128 tiles visit all 16).
//
// Design: a simple, correct kernel on the fp32 CUDA cores (no tensor
// cores, TMA or pipelining yet). A block of 256 threads owns one row and
// a tile of 64 queries; the grid puts the last (longest) query tiles
// first. The query tile stays in shared memory as fp32 for the whole
// loop; each 64-key tile of K and V is converted to fp32 in shared
// memory (113 KiB in all at D = 128, two blocks per SM). The threads
// form a 16×16 grid: thread (ti, tj) owns queries ti + 16r (r < 4), and
// within a key tile keys tj + 16c (c < 4) of the scores and columns
// tj + 16c (c < D/16) of acc, so the 16 threads that share a query are
// one half-warp and reduce its max and sum by shuffles; (m, l, acc) stay
// in registers. The scores P go through shared memory to the P·V
// product. Shared rows of Q, K and P are padded by one word so that the
// warps' reads do not conflict. Launches on the caller's stream,
// allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas body's NEG_INF
constexpr int kGrid = 16;          // threads per side of the thread grid
constexpr int kThreads = kGrid * kGrid;
constexpr int kTq = 64;            // queries per block
constexpr int kTk = 64;            // keys per step
constexpr int kRm = kTq / kGrid;   // queries per thread
constexpr int kRn = kTk / kGrid;   // keys per thread and step

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

// Shared memory: Q (kTq × D+1), K (kTk × D+1), V (kTk × D), P (kTq × kTk+1).
template <int D>
constexpr int smem_floats() {
  return kTq * (D + 1) + kTk * (D + 1) + kTk * D + kTq * (kTk + 1);
}

// max and sum over the 16 threads of a half-warp (one query's threads)
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = kGrid / 2; off > 0; off /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = kGrid / 2; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// grid (rows, ceil(t_len / kTq)); block kThreads; dynamic shared memory
// smem_floats<D>() floats. q, o: (rows, t_len, D); k, v: (rows, s_len, D).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int t_len,
                 int s_len, int t_off, int s_real, float scale) {
  static_assert(D % kGrid == 0, "D must be a multiple of 16");
  constexpr int LQ = D + 1, LP = kTk + 1, RD = D / kGrid;

  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTq * LQ;
  float* Vs = Ks + kTk * LQ;
  float* Ps = Vs + kTk * D;

  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTq;  // longest tiles first
  const size_t row = blockIdx.x;
  const T* __restrict__ Q = q + row * t_len * D;
  const T* __restrict__ K = k + row * s_len * D;
  const T* __restrict__ V = v + row * s_len * D;
  T* __restrict__ O = o + row * t_len * D;
  const int tid = threadIdx.x;
  const int ti = tid / kGrid, tj = tid % kGrid;

  for (int e = tid; e < kTq * D; e += kThreads) {
    const int r = e / D, c = e % D;
    Qs[r * LQ + c] =
        q0 + r < t_len ? to_float(Q[static_cast<size_t>(q0 + r) * D + c])
                       : 0.f;
  }

  float m[kRm], l[kRm], acc[kRm][RD];
#pragma unroll
  for (int r = 0; r < kRm; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < RD; ++c) acc[r][c] = 0.f;
  }

  // the last key any query of the block sees; the tiles after it are
  // masked for all of them (see the header)
  const int q_last = min(q0 + kTq, t_len) - 1;
  const int k_last = min(q_last + t_off, s_real - 1);
  const int n_kt = k_last / kTk + 1;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTk;
    __syncthreads();  // the last step's reads of K, V and P are done
    for (int e = tid; e < kTk * D; e += kThreads) {
      const int r = e / D, c = e % D;
      float kv = 0.f, vv = 0.f;
      if (k0 + r < s_len) {
        const size_t off = static_cast<size_t>(k0 + r) * D + c;
        kv = to_float(K[off]);
        vv = to_float(V[off]);
      }
      Ks[r * LQ + c] = kv;
      Vs[r * D + c] = vv;
    }
    __syncthreads();

    // -- scores q·k, then times scale, masked ------------------------------
    float sc[kRm][kRn];
#pragma unroll
    for (int r = 0; r < kRm; ++r)
#pragma unroll
      for (int c = 0; c < kRn; ++c) sc[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[kRm], b[kRn];
#pragma unroll
      for (int r = 0; r < kRm; ++r) a[r] = Qs[(ti + r * kGrid) * LQ + d];
#pragma unroll
      for (int c = 0; c < kRn; ++c) b[c] = Ks[(tj + c * kGrid) * LQ + d];
#pragma unroll
      for (int r = 0; r < kRm; ++r)
#pragma unroll
        for (int c = 0; c < kRn; ++c) sc[r][c] = fmaf(a[r], b[c], sc[r][c]);
    }

    // -- online softmax: (m, l, acc) of each query, P to shared memory ----
#pragma unroll
    for (int r = 0; r < kRm; ++r) {
      const int i = q0 + ti + r * kGrid;
      float mt = kNegInf;
#pragma unroll
      for (int c = 0; c < kRn; ++c) {
        const int j = k0 + tj + c * kGrid;
        const float s = sc[r][c] * scale;
        sc[r][c] = (j <= i + t_off && j < s_real) ? s : kNegInf;
        mt = fmaxf(mt, sc[r][c]);
      }
      const float m_new = fmaxf(m[r], half_warp_max(mt));
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kRn; ++c) {
        const float p = expf(sc[r][c] - m_new);
        Ps[(ti + r * kGrid) * LP + tj + c * kGrid] = p;
        sum += p;
      }
      l[r] = alpha * l[r] + half_warp_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < RD; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();

    // -- acc += P V --------------------------------------------------------
#pragma unroll 4
    for (int j = 0; j < kTk; ++j) {
      float a[kRm], b[RD];
#pragma unroll
      for (int r = 0; r < kRm; ++r) a[r] = Ps[(ti + r * kGrid) * LP + j];
#pragma unroll
      for (int c = 0; c < RD; ++c) b[c] = Vs[j * D + tj + c * kGrid];
#pragma unroll
      for (int r = 0; r < kRm; ++r)
#pragma unroll
        for (int c = 0; c < RD; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < kRm; ++r) {
    const int i = q0 + ti + r * kGrid;
    if (i >= t_len) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int c = 0; c < RD; ++c)
      O[static_cast<size_t>(i) * D + tj + c * kGrid] =
          from_float<T>(acc[r][c] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int rows,
           int t_len, int s_len, int t_off, int s_real, float scale,
           cudaStream_t stream) {
  constexpr size_t kSmem = smem_floats<D>() * sizeof(float);
  auto kernel = flash_fwd_kernel<T, D>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(rows, (t_len + kTq - 1) / kTq), block(kThreads);
  kernel<<<grid, block, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), t_len, s_len, t_off,
      s_real, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int rows,
             int t_len, int s_len, int d, int t_off, int s_real, float scale,
             cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, o, rows, t_len, s_len, t_off, s_real,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, rows, t_len, s_len, t_off, s_real,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, rows, t_len, s_len, t_off, s_real,
                            scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// B10. q, o: contiguous (rows, t, d); k, v: contiguous (rows, s, d); all
// of one type, fp32 (bf16 == 0) or bf16 (bf16 == 1), on the current
// device; d in {16, 64, 128}. Query i attends key j iff j <= i + t_off and
// j < s_real; requires t_off >= 0 and 1 <= s_real <= s (see the header).
// Returns cudaGetLastError() after the launch (or cudaErrorInvalidValue).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int rows, int t,
                                   int s, int d, int t_off, int s_real,
                                   float scale, int bf16, void* stream) {
  if (rows <= 0 || t <= 0 || s <= 0 || t_off < 0 || s_real < 1 ||
      s_real > s || (t + kTq - 1) / kTq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_d<__nv_bfloat16>(q, k, v, o, rows, t, s, d, t_off, s_real,
                                   scale, st);
  return launch_d<float>(q, k, v, o, rows, t, s, d, t_off, s_real, scale, st);
}
