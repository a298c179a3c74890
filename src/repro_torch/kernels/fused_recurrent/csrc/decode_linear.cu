// W fused decode steps of the linear-attention recurrence, for sm_90a.
//
// Replaces repro/kernels/fused_recurrent/kernel.py::decode_linear (the
// Pallas TPU kernel, all four bodies: _linear_kernel, _linear_norm_kernel,
// _linear_varlen_kernel, _linear_norm_varlen_kernel), as one kernel
// templated on <NORMALIZE, VARLEN>. Per state row n (one (batch, head)
// pair) and window step w < lens[n]:
//
//     S <- S + k vᵀ ;  z <- z + k ;  o = Sᵀq  [/ safe_denom(q·z)]
//
// (update, then read). A masked step (w >= lens[n]) leaves S and z bit for
// bit unchanged and writes exactly 0 to o.
//
// Bound: memory. Each row reads and writes its fp32 state once per launch
// and does O(Dk·Dv) flops per step. At the main-path shape (B=8, H=16 ->
// N=128, Dk=Dv=128, W=1) one launch moves about 128 × (2·64 KiB + 1 KiB)
// ≈ 17 MB: about 5 µs at 3.35 TB/s. Decode runs 28 launches per token,
// one per layer.
//
// Design: one block of 256 threads owns one state row. It loads S (held
// in registers: thread (g, j) keeps column j of rows g, g+G, g+2G, ...
// with G = 256/Dv, i.e. Dk·Dv/256 floats) and z (shared memory) once,
// loops over the W steps with q, k, v rows read from device memory, and
// writes S and z back once. The rank-1 update is a separate multiply and
// add (no FMA contraction), as the plain PyTorch version computes it, so
// the state agrees bit for bit; o and q·z are reduced in a fixed order.
// The kernel launches on the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

// sign(d)·max(|d|, eps), d == 0 -> +eps; NaN propagates
__device__ __forceinline__ float safe_denom(float d, float eps) {
  if (d != d) return d;
  return d >= 0.f ? fmaxf(d, eps) : fminf(d, -eps);
}

template <typename T, int D, bool NORMALIZE, bool VARLEN>
__global__ void __launch_bounds__(kThreads)
decode_linear_kernel(float* __restrict__ s, float* __restrict__ z,
                     const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     const int* __restrict__ lens, int w_steps, float eps) {
  constexpr int kGroups = kThreads / D;  // row groups
  constexpr int kRows = D / kGroups;     // rows of S held by each thread
  static_assert(kThreads % D == 0 && D % kGroups == 0, "unsupported D");

  __shared__ float qs[D], ks[D], vs[D], zs[D];
  __shared__ float part[kGroups][D];
  __shared__ float denom;

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
    if (NORMALIZE && tid < D) zs[tid] = z[static_cast<size_t>(n) * D + tid];

    for (int w = 0; w < len; ++w) {
      const size_t off = (row0 + w) * D;
      if (tid < D) {
        const float kt = to_float(k[off + tid]);
        qs[tid] = to_float(q[off + tid]);
        ks[tid] = kt;
        vs[tid] = to_float(v[off + tid]);
        if (NORMALIZE) zs[tid] = __fadd_rn(zs[tid], kt);
      }
      __syncthreads();

      const float vj = vs[col];
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = grp + r * kGroups;
        st[r] = __fadd_rn(st[r], __fmul_rn(ks[i], vj));
        acc = fmaf(st[r], qs[i], acc);
      }
      part[grp][col] = acc;
      if (NORMALIZE && tid < 32) {
        float d = 0.f;
        for (int i = tid; i < D; i += 32) d = fmaf(zs[i], qs[i], d);
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) d += __shfl_xor_sync(0xffffffffu, d, m);
        if (tid == 0) denom = safe_denom(d, eps);
      }
      __syncthreads();

      if (tid < D) {
        float out = 0.f;
#pragma unroll
        for (int g = 0; g < kGroups; ++g) out += part[g][tid];
        if (NORMALIZE) out = __fdiv_rn(out, denom);
        o[off + tid] = from_float<T>(out);
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) s_n[(grp + r * kGroups) * D + col] = st[r];
    if (NORMALIZE && tid < D) z[static_cast<size_t>(n) * D + tid] = zs[tid];
  }

  for (int w = len; w < w_steps; ++w)
    for (int j = tid; j < D; j += kThreads)
      o[(row0 + w) * D + j] = from_float<T>(0.f);
}

template <typename T, int D>
void launch(float* s, float* z, const void* q, const void* k, const void* v,
            void* o, const int* lens, int n, int w, float eps, bool normalize,
            cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  const dim3 grid(n), block(kThreads);
  if (normalize) {
    if (lens)
      decode_linear_kernel<T, D, true, true>
          <<<grid, block, 0, stream>>>(s, z, qt, kt, vt, ot, lens, w, eps);
    else
      decode_linear_kernel<T, D, true, false>
          <<<grid, block, 0, stream>>>(s, z, qt, kt, vt, ot, lens, w, eps);
  } else {
    if (lens)
      decode_linear_kernel<T, D, false, true>
          <<<grid, block, 0, stream>>>(s, z, qt, kt, vt, ot, lens, w, eps);
    else
      decode_linear_kernel<T, D, false, false>
          <<<grid, block, 0, stream>>>(s, z, qt, kt, vt, ot, lens, w, eps);
  }
}

template <typename T>
int launch_dtype(float* s, float* z, const void* q, const void* k,
                 const void* v, void* o, const int* lens, int n, int w, int d,
                 float eps, bool normalize, cudaStream_t stream) {
  switch (d) {
    case 16: launch<T, 16>(s, z, q, k, v, o, lens, n, w, eps, normalize, stream); break;
    case 128: launch<T, 128>(s, z, q, k, v, o, lens, n, w, eps, normalize, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// s: (n, d, d) fp32, z: (n, d) fp32 or null (normalize == 0), both updated
// in place; q, k, v: (n, w, d) and o: (n, w, d) in fp32 (bf16 == 0) or
// bf16 (bf16 == 1); lens: (n,) int32 or null. All contiguous, on the
// current device. Returns cudaGetLastError() after the launch.
extern "C" int decode_linear(void* s, void* z, const void* q, const void* k,
                             const void* v, void* o, const void* lens, int n,
                             int w, int d, int bf16, int normalize, float eps,
                             void* stream) {
  if (n <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (normalize && z == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int* l = static_cast<const int*>(lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc =
      bf16 ? launch_dtype<__nv_bfloat16>(static_cast<float*>(s), static_cast<float*>(z),
                                         q, k, v, o, l, n, w, d, eps, normalize != 0, st)
           : launch_dtype<float>(static_cast<float*>(s), static_cast<float*>(z),
                                 q, k, v, o, l, n, w, d, eps, normalize != 0, st);
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}
