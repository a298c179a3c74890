// W fused decode steps of the gated (decay) linear-attention recurrence,
// for sm_90a.
//
// Replaces repro/kernels/fused_recurrent/kernel.py::decode_gated (the
// Pallas TPU kernel, both bodies: _gated_kernel and _gated_varlen_kernel),
// as one kernel templated on <VARLEN>. Per state row n (one (batch, head)
// pair) and window step w < lens[n], with a = exp(g) and no clamp on g:
//
//     S <- diag(a) S + k vᵀ ;  o = Sᵀq
//
// (decay and update, then read: the inclusive form). A masked step
// (w >= lens[n]) neither decays nor updates: S stays bit for bit as it
// was and o is exactly 0.
//
// Bound: memory. Each row reads and writes its fp32 state once per launch
// and does O(Dk·Dv) flops per step. At the main-path shape (B=8, H=16 ->
// N=128, Dk=Dv=128, W=1, bf16 q/k/v, fp32 g) one launch moves
// 16,777,216 B of state + 98,304 B of q, k, v + 65,536 B of g + 32,768 B
// of o ≈ 16.97 MB: about 5.07 µs at 3.35 TB/s. Decode runs 28 launches
// per token, one per layer.
//
// Design: B1's layout and head dims (decode_linear.cu). One block owns
// one state row, 256 threads where D divides 256, else 3·D (288 at
// D = 96) or 4·D (448 at D = 112): thread (grp, j) keeps column j of
// rows grp, grp+G, ... (G = threads/D) in registers, loaded once and written back once. Each
// step stages the q, k, v rows and a = expf(g) (computed once per row i)
// in shared memory. The update is S[i][j] = a[i]·S[i][j] + k[i]·v[j] with
// each product and the sum rounded separately (no FMA contraction, no
// fast math), as the plain PyTorch version computes it, so the state can
// agree bit for bit; o is reduced in a fixed order. The kernel launches on
// the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// Threads of the block that owns one state row of head dim D: 256 where
// D divides it (D = 16, 64, 128: 256 / D row groups), else row groups of
// D threads that divide D's rows and fill whole warps: three at D = 96
// (288 threads, 32 rows of S each), four at D = 112 (448 threads, 28
// rows each; three would leave 112 rows uneven).
template <int D>
__host__ __device__ constexpr int block_threads() {
  return 256 % D == 0 ? 256 : D == 112 ? 4 * D : 3 * D;
}

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

template <typename T, int D, bool VARLEN>
__global__ void __launch_bounds__(block_threads<D>())
decode_gated_kernel(float* __restrict__ s, const T* __restrict__ q,
                    const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ g, T* __restrict__ o,
                    const int* __restrict__ lens, int w_steps) {
  constexpr int kThreads = block_threads<D>();
  constexpr int kGroups = kThreads / D;  // row groups
  constexpr int kRows = D / kGroups;     // rows of S held by each thread
  static_assert(kThreads % D == 0 && D % kGroups == 0 && kThreads % 32 == 0
                && kThreads <= 1024, "unsupported D");

  __shared__ float qs[D], ks[D], vs[D], decay[D];
  __shared__ float part[kGroups][D];

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int col = tid % D;
  const int grp = tid / D;
  float* s_n = s + static_cast<size_t>(n) * D * D;
  const size_t row0 = static_cast<size_t>(n) * w_steps;

  int len = w_steps;
  if (VARLEN) len = min(max(lens[n], 0), w_steps);

  if (len > 0) {
    float st[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) st[r] = s_n[(grp + r * kGroups) * D + col];

    for (int w = 0; w < len; ++w) {
      const size_t off = (row0 + w) * D;
      if (tid < D) {
        qs[tid] = to_float(q[off + tid]);
        ks[tid] = to_float(k[off + tid]);
        vs[tid] = to_float(v[off + tid]);
        decay[tid] = expf(g[off + tid]);
      }
      __syncthreads();

      const float vj = vs[col];
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = grp + r * kGroups;
        st[r] = __fadd_rn(__fmul_rn(decay[i], st[r]), __fmul_rn(ks[i], vj));
        acc = fmaf(st[r], qs[i], acc);
      }
      part[grp][col] = acc;
      __syncthreads();

      if (tid < D) {
        float out = 0.f;
#pragma unroll
        for (int gi = 0; gi < kGroups; ++gi) out += part[gi][tid];
        o[off + tid] = from_float<T>(out);
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) s_n[(grp + r * kGroups) * D + col] = st[r];
  }

  for (int w = len; w < w_steps; ++w)
    for (int j = tid; j < D; j += kThreads)
      o[(row0 + w) * D + j] = from_float<T>(0.f);
}

template <typename T, int D>
void launch(float* s, const void* q, const void* k, const void* v,
            const float* g, void* o, const int* lens, int n, int w,
            cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  const dim3 grid(n), block(block_threads<D>());
  if (lens)
    decode_gated_kernel<T, D, true>
        <<<grid, block, 0, stream>>>(s, qt, kt, vt, g, ot, lens, w);
  else
    decode_gated_kernel<T, D, false>
        <<<grid, block, 0, stream>>>(s, qt, kt, vt, g, ot, lens, w);
}

template <typename T>
int launch_dtype(float* s, const void* q, const void* k, const void* v,
                 const float* g, void* o, const int* lens, int n, int w,
                 int d, cudaStream_t stream) {
  switch (d) {
    case 16: launch<T, 16>(s, q, k, v, g, o, lens, n, w, stream); break;
    case 64: launch<T, 64>(s, q, k, v, g, o, lens, n, w, stream); break;
    case 96: launch<T, 96>(s, q, k, v, g, o, lens, n, w, stream); break;
    case 112: launch<T, 112>(s, q, k, v, g, o, lens, n, w, stream); break;
    case 128: launch<T, 128>(s, q, k, v, g, o, lens, n, w, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// s: (n, d, d) fp32, updated in place; q, k, v: (n, w, d) and o: (n, w, d)
// in fp32 (bf16 == 0) or bf16 (bf16 == 1); g: (n, w, d) fp32 log-decay;
// lens: (n,) int32 or null. All contiguous, on the current device.
// Returns cudaGetLastError() after the launch.
extern "C" int decode_gated(void* s, const void* q, const void* k,
                            const void* v, const void* g, void* o,
                            const void* lens, int n, int w, int d, int bf16,
                            void* stream) {
  if (n <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int* l = static_cast<const int*>(lens);
  const float* gf = static_cast<const float*>(g);
  float* sf = static_cast<float*>(s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc =
      bf16 ? launch_dtype<__nv_bfloat16>(sf, q, k, v, gf, o, l, n, w, d, st)
           : launch_dtype<float>(sf, q, k, v, gf, o, l, n, w, d, st);
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}
