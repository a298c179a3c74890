// The paper's fast lookups for sm_90a: three kernels, one source.
//
// B4  mass_lookup_kernel<TM, KC, INDEXED=true>
//     replaces repro/kernels/lookup/kernel.py::mass_lookup_indexed
//     (_mass_lookup_indexed_kernel). A heterogeneous query wave:
//         o[b, m, i] = Σ_l q[b, m, l] · store[rows[b], i, l]
//     (O = Q Cᵀ per row; C need not be symmetric).
// B5  mass_lookup_kernel<TM, KC, INDEXED=false>
//     replaces repro/kernels/lookup/kernel.py::mass_lookup
//     (_mass_lookup_kernel): the same with rows[b] = b.
// B6  decode_kernel<T>
//     replaces repro/kernels/lookup/kernel.py::decode (_decode_kernel):
//         S <- S + k vᵀ (in place) ;  o[v] = Σ_k q[k] · S[k, v].
//
// Bound: memory, for all three. B4 and B5 read a K×K fp32 state for every
// 2·M·K² flops; at the lookup main path (B = 256 rows of a 16,384-row
// store, M = 1, K = 64) one launch reads 256 × 16 KiB of state, ~4.3 MB
// with q and o: ~1.3 µs at 3.35 TB/s, against ~0.03 µs of fp32 work at
// 67 TFLOP/s. B6 reads and writes its state once per step (2·Dk·Dv·4
// bytes for 4·Dk·Dv flops).
//
// Design, B4/B5: one block of 8 warps per (wave row, tile of TM queries).
// The block loads its own rows[b] (the Pallas scalar prefetch), keeps the
// tile's queries in registers (lane j holds q[t, lane + 32·c], c < KC) and
// streams the state straight from device memory in coalesced 128-byte
// rows: warp w takes R consecutive state rows C[i, :] at a time (R·KC =
// 16 loads in flight per lane), multiplies them with every query of the
// tile in fp32 FMAs, and reduces each dot product across the warp with
// shuffles. The state never goes through shared memory, so any K up to
// 256 fits (K = 256 would need 256 KiB, more than a block can have);
// lanes past K (K = 100) are masked. Only the (TM, K) output tile is
// staged in shared memory, to be written back coalesced. A row index
// outside the store yields NaN rather than a read outside it.
//
// Design, B6: one block per state row, threads (tx, ty) = (32, 8); thread
// (tx, ty) updates columns tx + 32·c of rows ty, ty + 8, ... in place and
// keeps their partial sums of o; the 8 partial sums of each column are
// added in a fixed order through shared memory. The rank-1 update is a
// separately rounded multiply and add (__fmul_rn, __fadd_rn), as the
// plain PyTorch version computes it, so the state agrees bit for bit.
//
// Every kernel launches on the caller's stream and allocates nothing; each
// C entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxK = 256;            // largest K (B4/B5) and Dk, Dv (B6)
constexpr int kLoadsInFlight = 16;    // state values a lane loads at once

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

// B4 (INDEXED) and B5. c: (n_states, k, k); rows: (b,) int32 (INDEXED);
// q, o: (b, m, k). KC = lane chunks per state row (KC · 32 >= k).
template <int TM, int KC, bool INDEXED>
__global__ void __launch_bounds__(kThreads)
mass_lookup_kernel(const float* __restrict__ c, const int* __restrict__ rows,
                   const float* __restrict__ q, float* __restrict__ o,
                   int n_states, int m, int k) {
  constexpr int R = kLoadsInFlight / KC;  // state rows a warp loads at once
  __shared__ float os[TM][kMaxK];

  const int b = blockIdx.x;
  const int m0 = blockIdx.y * TM;
  const int tm = min(TM, m - m0);         // queries of this tile
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t tile = (static_cast<size_t>(b) * m + m0) * k;
  const float* q_t = q + tile;
  float* o_t = o + tile;

  const int row = INDEXED ? rows[b] : b;
  if (row < 0 || row >= n_states) {
    for (int x = threadIdx.x; x < tm * k; x += kThreads)
      o_t[x] = __int_as_float(0x7fc00000);
    return;
  }
  const float* c_n = c + static_cast<size_t>(row) * k * k;

  float qr[TM][KC];
#pragma unroll
  for (int t = 0; t < TM; ++t)
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      const int l = lane + 32 * j;
      qr[t][j] = (t < tm && l < k) ? q_t[t * k + l] : 0.f;
    }

  for (int i0 = warp * R; i0 < k; i0 += kWarps * R) {
    float ci[R][KC];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const int i = i0 + r, l = lane + 32 * j;
        ci[r][j] = (i < k && l < k) ? __ldg(c_n + static_cast<size_t>(i) * k + l)
                                    : 0.f;
      }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int t = 0; t < TM; ++t) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < KC; ++j) acc = fmaf(qr[t][j], ci[r][j], acc);
#pragma unroll
        for (int s = 16; s > 0; s >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, s);
        if (lane == 0 && i0 + r < k) os[t][i0 + r] = acc;
      }
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < tm * k; x += kThreads)
    o_t[x] = os[x / k][x % k];
}

// B6. s: (n, dk, dv) fp32, updated in place; q, k: (n, dk); v, o: (n, dv).
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_kernel(float* __restrict__ s, const T* __restrict__ q,
              const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ o, int dk, int dv) {
  constexpr int kCols = kMaxK / 32;       // columns per thread, at most
  __shared__ float qs[kMaxK], ks[kMaxK];
  __shared__ float part[kWarps][kMaxK];

  const int n = blockIdx.x;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  for (int a = threadIdx.x; a < dk; a += kThreads) {
    qs[a] = to_float(q[static_cast<size_t>(n) * dk + a]);
    ks[a] = to_float(k[static_cast<size_t>(n) * dk + a]);
  }
  float vr[kCols], acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int col = tx + 32 * j;
    vr[j] = col < dv ? to_float(v[static_cast<size_t>(n) * dv + col]) : 0.f;
    acc[j] = 0.f;
  }
  __syncthreads();

  float* s_n = s + static_cast<size_t>(n) * dk * dv;
#pragma unroll 4
  for (int a = ty; a < dk; a += kWarps) {
    const float ka = ks[a], qa = qs[a];
    float* s_a = s_n + static_cast<size_t>(a) * dv;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = tx + 32 * j;
      if (col < dv) {
        const float x = __fadd_rn(s_a[col], __fmul_rn(ka, vr[j]));
        s_a[col] = x;
        acc[j] = fmaf(qa, x, acc[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int col = tx + 32 * j;
    if (col < dv) part[ty][col] = acc[j];
  }
  __syncthreads();
  for (int col = threadIdx.x; col < dv; col += kThreads) {
    float sum = 0.f;
#pragma unroll
    for (int g = 0; g < kWarps; ++g) sum += part[g][col];
    o[static_cast<size_t>(n) * dv + col] = from_float<T>(sum);
  }
}

template <int TM, int KC>
void launch_lookup(const float* c, const int* rows, const float* q, float* o,
                   int n_states, int b, int m, int k, cudaStream_t stream) {
  const dim3 grid(b, (m + TM - 1) / TM), block(kThreads);
  if (rows)
    mass_lookup_kernel<TM, KC, true>
        <<<grid, block, 0, stream>>>(c, rows, q, o, n_states, m, k);
  else
    mass_lookup_kernel<TM, KC, false>
        <<<grid, block, 0, stream>>>(c, rows, q, o, n_states, m, k);
}

template <int TM>
int launch_tile(const float* c, const int* rows, const float* q, float* o,
                int n_states, int b, int m, int k, cudaStream_t stream) {
  const int kc = (k + 31) / 32;
  if (kc <= 1) launch_lookup<TM, 1>(c, rows, q, o, n_states, b, m, k, stream);
  else if (kc <= 2) launch_lookup<TM, 2>(c, rows, q, o, n_states, b, m, k, stream);
  else if (kc <= 4) launch_lookup<TM, 4>(c, rows, q, o, n_states, b, m, k, stream);
  else launch_lookup<TM, 8>(c, rows, q, o, n_states, b, m, k, stream);
  return 0;
}

}  // namespace

// B4 (rows != null) and B5 (rows == null: row b reads state b, and
// n_states must equal b). c: (n_states, k, k), q and o: (b, m, k), fp32;
// rows: (b,) int32. All contiguous, on the current device; 1 <= k <= 256.
extern "C" int mass_lookup(const void* c, const void* rows, const void* q,
                           void* o, int n_states, int b, int m, int k,
                           void* stream) {
  if (b <= 0 || m <= 0 || k <= 0 || k > kMaxK || n_states <= 0 ||
      (rows == nullptr && n_states != b))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* cf = static_cast<const float*>(c);
  const int* r = static_cast<const int*>(rows);
  const float* qf = static_cast<const float*>(q);
  float* of = static_cast<float*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m == 1) launch_tile<1>(cf, r, qf, of, n_states, b, m, k, st);
  else launch_tile<4>(cf, r, qf, of, n_states, b, m, k, st);
  return static_cast<int>(cudaGetLastError());
}

// B6. s: (n, dk, dv) fp32, updated in place; q, k: (n, dk) and v: (n, dv)
// in fp32 (bf16 == 0) or bf16 (bf16 == 1); o: (n, dv) in v's type. All
// contiguous, on the current device; 1 <= dk, dv <= 256.
extern "C" int lookup_decode(void* s, const void* q, const void* k,
                             const void* v, void* o, int n, int dk, int dv,
                             int bf16, void* stream) {
  if (n <= 0 || dk <= 0 || dv <= 0 || dk > kMaxK || dv > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sf = static_cast<float*>(s);
  if (bf16) {
    using T = __nv_bfloat16;
    decode_kernel<T><<<n, kThreads, 0, st>>>(
        sf, static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), dk, dv);
  } else {
    decode_kernel<float><<<n, kThreads, 0, st>>>(
        sf, static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), dk, dv);
  }
  return static_cast<int>(cudaGetLastError());
}
