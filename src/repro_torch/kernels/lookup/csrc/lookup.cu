// The paper's fast lookups for sm_90a: three functions, one source.
//
// B4  mass_lookup_bulk<KS, TM, VEC, INDEXED=true>, and for odd K
//     mass_lookup_direct<TM, KC, INDEXED=true>
//     replace repro/kernels/lookup/kernel.py::mass_lookup_indexed
//     (_mass_lookup_indexed_kernel). A heterogeneous query wave:
//         o[b, m, i] = Σ_l q[b, m, l] · store[rows[b], i, l]
//     (O = Q Cᵀ per row; C need not be symmetric).
// B5  the same kernels with INDEXED=false
//     replace repro/kernels/lookup/kernel.py::mass_lookup
//     (_mass_lookup_kernel): the same with rows[b] = b.
// B6  decode_bulk<T, KC>, and for other shapes decode_direct<T, KC, R>
//     replace repro/kernels/lookup/kernel.py::decode (_decode_kernel):
//         S <- S + k vᵀ (in place) ;  o[v] = Σ_k q[k] · S[k, v].
//
// Bound: memory, for all three. B4 and B5 read a K×K fp32 state for every
// 2·M·K² flops, at most 2 flops a byte for M <= 4 against the card's 20
// (67 TFLOP/s over 3.35 TB/s): bytes and latency bind, and fp32 FMAs are
// enough. At the lookup main path (B = 256 rows of a 16,384-row store,
// M = 1, K = 64) one launch reads 256 × 16 KiB of state, ~4.3 MB with q
// and o: ~1.3 µs at 3.35 TB/s. B6 reads and writes its state once per step
// (2·Dk·Dv·4 bytes for 4·Dk·Dv flops): at N = 256, Dk = Dv = 100 one
// launch moves 20.9 MB, ~6.2 µs.
//
// Design, B4/B5, even K (the bulk route, mass_lookup_bulk): one block of 8
// warps per wave row, looping over the row's tiles of TM queries, so that
// the state crosses device memory once for all M queries (the Pallas grid
// keeps the state block fixed across its M tiles). Warp w answers a
// contiguous run of the state's rows (warp_rows). Every thread reads
// rows[b] itself (the Pallas scalar prefetch); as soon as it is known,
// lane 0 of the first warp of each half of the block copies that half's
// rows into shared memory with one bulk asynchronous copy (cp.async.bulk,
// the TMA's 1-D form) completing on an mbarrier, while every lane loads
// its columns of the queries. For K <= 128 the whole state stays resident
// (64 KiB at K = 128); above (256 KiB at K = 256, more than a block may
// have) each warp streams its own rows in copies of 4 through a ring of 2
// stages, refilled as the warp finishes with one, once per tile; KS fixes
// the route at compile time. Past the
// barriers' initialisation no warp waits for another. A group of 32/VEC
// lanes takes one state row, lane j reading columns VEC·j + 32s with one
// VEC-wide shared load (16 bytes where K % 4 == 0 and the state is
// resident, else 8), so that the group reads 128 contiguous bytes, free of
// bank conflicts (a thread per output i reading C[i][l] would be a 32-way
// conflict at K = 64, 128, 256). Each lane keeps its columns of the
// tile's queries in registers and multiplies them with the row in fp32
// FMAs; the TM dot products are summed over the group by a folding
// reduction (4 shuffles for TM = 4 over 8 lanes, not 12), two or four row
// steps at once so that their loads and shuffles overlap, and one lane
// writes each answer. The H100 measurements (PERF.md) chose few, large
// copies, 16-byte shared loads, no block-wide barrier after the start and
// answers stored where they are summed (the (TM, K) tile staged in shared
// memory and stored 16 bytes at a time ran slower, behind a block barrier
// or per warp).
// A bulk copy takes a 16-byte aligned source and a multiple of 16 bytes:
// both hold for even K once the store is 16-byte aligned, which the
// wrapper checks (q: aligned to its loads).
//
// Design, B4/B5, odd K (the direct-load route, mass_lookup_direct; no path
// of the system uses an odd K, but JAX takes any): one block of 8 warps per
// (wave row, tile of TM queries); the tile's queries in registers (lane j
// holds q[t, lane + 32·c], c < KC) and the state streamed straight from
// device memory in coalesced 128-byte rows: warp w takes R consecutive
// state rows C[i, :] at a time (R·KC = 16 loads in flight per lane),
// multiplies them with every query of the tile and reduces each dot
// product across the warp with shuffles. Only the (TM, K) output tile is
// staged in shared memory.
//
// On both routes a row index outside the store yields NaN for that row
// rather than a read outside it.
//
// Design, B6, dk·dv % 4 == 0 and a state of at most 192 KiB (the bulk
// route, decode_bulk): one block per state, the state held in dynamic
// shared memory in its global (dk, dv) layout, in eight chunks: warp w
// owns a contiguous run of rows (warp_rows, in steps of rows that span a
// multiple of 16 bytes), which its lane 0 copies in by one bulk copy
// (cp.async.bulk) on the warp's mbarrier, so that the whole state is in
// flight from the start; meanwhile lane i loads q and k of the warp's row
// r0 + i (broadcast by shuffles) and every lane v of its columns lane +
// 32j. The warp waits, updates its rows in shared memory (8 values a lane
// loaded before any is stored), adds q[a]·S'[a, c] to its partial sums of
// o, fences the writes to the async proxy, and lane 0 stores the rows back
// by one bulk copy while other warps' copies still land. Two or four
// copies a warp, each on its own mbarrier and stored back as soon as it
// was updated, ran 0.1-0.5 µs slower at the paper's width and the LM's
// shape on the H100 (PERF.md). No block-wide barrier comes before o's
// partials, which are summed in a fixed order by two to eight threads a
// column (sum_partials); lane 0 waits for its stores to have read shared
// memory (cp.async.bulk.wait_group.read) before the block exits. States
// above 192 KiB (256 × 256 is 256 KiB, more than a block may hold) take
// the direct route rather than a ring of stages: no path of the system
// runs B6, the paper's width (40 KB) and the LM's 128 × 128 (64 KiB) are
// resident, and the direct body serves the rest.
//
// Design, B6, any other shape (the direct route, decode_direct; the bulk
// copies need a 16-byte aligned source and a multiple of 16 bytes): one
// block per state, thread (tx, ty) = (32, 8) updating columns tx + 32j of
// rows ty, ty + 8, ... in place, R rows at a time with all their loads
// issued before any store (8 rows of up to 4 columns, 4 of 8), its
// partial sums of o summed as above; at most 128 registers, so that two
// blocks share an SM.
//
// On both routes the rank-1 update is a separately rounded multiply and
// add (__fmul_rn, __fadd_rn), as the plain PyTorch version computes it, so
// the state agrees bit for bit.
//
// Every kernel launches on the caller's stream and allocates nothing; each
// C entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "../../csrc/hopper.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxK = 256;            // largest K (B4/B5) and Dk, Dv (B6)
constexpr int kLoadsInFlight = 16;    // direct route: values a lane loads at once
// the bulk route
constexpr int kResidentK = 128;   // up to this K the whole state is resident
constexpr int kCopies = 2;        // resident: bulk copies per state, each
                                  // of the rows of kWarps / kCopies warps
constexpr int kRingRows = 4;      // above it, each warp streams its rows in
constexpr int kRingStages = 2;    // copies of 4 through a ring of 2 stages
constexpr int kDecodeResident = 48 * 1024;  // B6's bulk route: its largest
                                            // state, 192 KiB

// The state rows [r0, r1) of warp w: the K rows in steps of rs (the rows
// one warp answers at once: 4 with 16-byte loads, 2 with 8-byte ones), the
// first K/rs % 8 warps taking one step more. A step of 2 rows moves a
// multiple of 16 bytes at any even K, so every copy starts on a 16-byte
// boundary and moves a multiple of 16 bytes.
__device__ __forceinline__ void warp_rows(int k, int rs, int w, int& r0,
                                          int& r1) {
  const int steps = (k + rs - 1) / rs, base = steps / kWarps;
  const int extra = steps % kWarps;
  const int s0 = w * base + min(w, extra), n = base + (w < extra);
  r0 = min(k, s0 * rs);
  r1 = min(k, (s0 + n) * rs);
}
// the bulk route's dynamic shared memory: the state (whole, or each warp's
// ring), then the mbarriers (kCopies, or kRingStages per warp). A state
// row of KS 32-column slices rides the ring where KS > kResidentK / 32.
__host__ __device__ constexpr bool ring_route(int ks) {
  return 32 * ks > kResidentK;
}
__host__ __device__ constexpr int bulk_state_floats(int k) {
  return k <= kResidentK ? k * k : kWarps * kRingStages * kRingRows * k;
}
constexpr int bulk_smem_bytes(int k) {
  return bulk_state_floats(k) * 4 + kWarps * kRingStages * 8;
}

// B6's route: the bulk route where a state is a whole number of 16-byte
// units and fits in a block's shared memory beside o's partial sums
// (ops.decode_route states the same rule for the wrapper's checks)
__host__ __device__ constexpr bool decode_bulk_route(int dk, int dv) {
  return dk * dv % 4 == 0 && dk * dv <= kDecodeResident;
}
// the bulk route's dynamic shared memory: the state, o's kWarps partial
// sums of each column, then the mbarriers (one per warp)
constexpr int decode_smem_bytes(int floats, int dv) {
  return (floats + kWarps * dv) * 4 + kWarps * 8;
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

// Sums each of the N values in v over a group of G = 2·OFF lanes by
// folding: at each halving of the values, the lanes with bit OFF set keep
// the upper half and their partners the lower, one shuffle per value kept.
// Lane j of the group ends with the sum of value j / (G / N) in v[0].
template <int N, int OFF, int TM>
__device__ __forceinline__ void fold(float (&v)[TM], int lane) {
  if constexpr (OFF > 0) {
    if constexpr (N > 1) {
      const bool up = lane & OFF;
#pragma unroll
      for (int x = 0; x < N / 2; ++x) {
        const float send = up ? v[x] : v[x + N / 2];
        const float keep = up ? v[x + N / 2] : v[x];
        v[x] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      fold<N / 2, OFF / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
      fold<1, OFF / 2>(v, lane);
    }
  }
}

// bytes of the state at src into shared memory at dst, completing on bar
__device__ __forceinline__ void copy_rows(uint32_t bar, float* dst,
                                          const float* src, int bytes) {
  tc::mbar_expect_tx(bar, bytes);
  tc::bulk_load(tc::smem_u32(dst), src, bytes, bar);
}

// VEC floats from p (VEC = 4: 16-byte aligned; 2: 8-byte aligned)
template <int VEC, bool GLOBAL>
__device__ __forceinline__ void load_vec(float (&v)[VEC], const float* p) {
  if constexpr (VEC == 4) {
    const float4 x = GLOBAL ? __ldg(reinterpret_cast<const float4*>(p))
                            : *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    const float2 x = GLOBAL ? __ldg(reinterpret_cast<const float2*>(p))
                            : *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  }
}

// lane j's columns VEC·j + 32s .. + VEC - 1 (s < KS) of the tile's queries
// t < tm, zero past them
template <int KS, int TM, int VEC>
__device__ __forceinline__ void load_q(float (&qr)[TM][KS][VEC],
                                       const float* q_t, int tm, int k,
                                       int j) {
#pragma unroll
  for (int t = 0; t < TM; ++t)
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const int l = VEC * j + 32 * s;
      if (t < tm && l < k) {
        load_vec<VEC, true>(qr[t][s], q_t + t * k + l);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) qr[t][s][e] = 0.f;
      }
    }
}

// The answers of n_steps steps of rows to the tile's queries: step n
// holds rows row0 + n·stride + (0 .. 32/G - 1), those below limit, state
// row i held in shared memory at rows0 + (i - row0)·k. A group of G =
// 32 / VEC lanes takes one row, lane j reading its columns VEC·j + 32s as
// one VEC-wide shared load, so that a group reads 128 contiguous bytes:
// free of bank conflicts for any K that the load's width divides (a thread
// per output i reading C[i][l] would be a 32-way conflict at K = 64, 128,
// 256). U steps at a time, so that their loads, FMAs and folds overlap;
// each sum is written to o_t[t·k + i] by one lane.
template <int KS, int TM, int VEC, int U>
__device__ __forceinline__ void answer_steps(const float* rows0, int row0,
                                             int stride, int n_steps,
                                             int limit,
                                             const float (&qr)[TM][KS][VEC],
                                             float* o_t, int tm, int k,
                                             int lane) {
  constexpr int G = 128 / (4 * VEC);               // lanes per row
  const int j = lane % G, sub = lane / G;
  for (int n0 = 0; n0 < n_steps; n0 += U) {
    float acc[U][TM];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = row0 + (n0 + u) * stride + sub;
#pragma unroll
      for (int t = 0; t < TM; ++t) acc[u][t] = 0.f;
      if (n0 + u < n_steps && i < limit) {
        const float* c_i = rows0 + (i - row0) * k;
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          const int l = VEC * j + 32 * s;
          if (l < k) {
            float cv[VEC];
            load_vec<VEC, false>(cv, c_i + l);
#pragma unroll
            for (int t = 0; t < TM; ++t)
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                acc[u][t] = fmaf(qr[t][s][e], cv[e], acc[u][t]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      fold<TM, G / 2>(acc[u], lane);
      const int i = row0 + (n0 + u) * stride + sub, t = j / (G / TM);
      if (n0 + u < n_steps && i < limit && j % (G / TM) == 0 && t < tm)
        o_t[t * k + i] = acc[u][0];
    }
  }
}

// B4 (INDEXED) and B5 for even k, the bulk route. c: (n_states, k, k),
// 16-byte aligned; rows: (b,) int32 (INDEXED); q, o: (b, m, k), q aligned
// to VEC floats. One block per wave row; KS = 32-column slices per state
// row (32·KS >= k); VEC = 4 (K % 4 == 0, K <= 128) or 2: the width of the
// shared loads.
template <int KS, int TM, int VEC, bool INDEXED>
__global__ void __launch_bounds__(kThreads, 2)   // two blocks an SM
mass_lookup_bulk(const float* __restrict__ c, const int* __restrict__ rows,
                 const float* __restrict__ q, float* __restrict__ o,
                 int n_states, int m, int k) {
  constexpr int G = 128 / (4 * VEC);                  // lanes per row
  constexpr int RS = 32 / G;                          // rows per step
  extern __shared__ __align__(16) float smem[];
  const uint32_t bar0 = tc::smem_u32(smem + bulk_state_floats(k));
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_tiles = (m + TM - 1) / TM;
  const int row = INDEXED ? __ldg(rows + b) : b;   // every thread reads it
  const bool valid = row >= 0 && row < n_states;
  const float* c_n = c + static_cast<size_t>(row) * k * k;
  const float* q_b = q + static_cast<size_t>(b) * m * k;
  float* o_b = o + static_cast<size_t>(b) * m * k;
  float qr[TM][KS][VEC];

  int r0, r1;           // this warp's state rows (warp_rows)
  warp_rows(k, RS, warp, r0, r1);

  if constexpr (!ring_route(KS)) {
    // Resident: lane 0 of the first warp of each group of kWarps / kCopies
    // warps copies the group's rows as soon as the row is known; each warp
    // answers every tile from shared memory once its group's copy lands.
    // row steps at once: with 16-byte loads a warp has at most KS steps
    // (K / 4 over 8 warps), all taken at once past K = 64
    constexpr int U = VEC == 4 && KS <= 2 ? 2 : 4;
    constexpr int group = kWarps / kCopies;
    const uint32_t bar = bar0 + 8 * (warp / group);
    if (lane == 0 && warp % group == 0) {
      tc::mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      int g0, g1;       // the group's last warp's rows end at g1
      warp_rows(k, RS, warp + group - 1, g0, g1);
      if (valid && g1 > r0)
        copy_rows(bar, smem + r0 * k, c_n + r0 * k, (g1 - r0) * k * 4);
    }
    load_q(qr, q_b, min(TM, m), k, lane % G);
    __syncthreads();    // the barriers, initialised, before any wait
    if (!valid) {       // NaN answers, nothing read
      for (int x = threadIdx.x; x < m * k; x += kThreads)
        o_b[x] = __int_as_float(0x7fc00000);
      return;
    }
    if (r1 <= r0) return;
    tc::mbar_wait(bar, 0);
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int m0 = tile * TM, tm = min(TM, m - m0);
      if (tile > 0) load_q(qr, q_b + m0 * k, tm, k, lane % G);
      answer_steps<KS, TM, VEC, U>(smem + r0 * k, r0, RS,
                                   (r1 - r0 + RS - 1) / RS, r1, qr,
                                   o_b + m0 * k, tm, k, lane);
    }
  } else {
    // The ring: warp w streams its own rows [r0, r1) in copies of kRingRows
    // through kRingStages stages, once per tile, lane 0 issuing them and
    // refilling each stage as the warp finishes with it.
    const uint32_t bar = bar0 + 8 * kRingStages * warp;
    float* const ring = smem + warp * kRingStages * kRingRows * k;
    const int n_ch = (r1 - r0 + kRingRows - 1) / kRingRows;
    const int n_copies = n_tiles * n_ch;
    // copy g: chunk g % n_ch of this warp's rows into stage g % kRingStages
    const auto issue = [&](int g) {
      const int i0 = r0 + (g % n_ch) * kRingRows;
      copy_rows(bar + 8 * (g % kRingStages),
                ring + (g % kRingStages) * kRingRows * k, c_n + i0 * k,
                min(kRingRows, r1 - i0) * k * 4);
    };
    if (lane == 0) {
      for (int st = 0; st < kRingStages; ++st) tc::mbar_init(bar + 8 * st, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      if (valid)
        for (int g = 0; g < min(kRingStages, n_copies); ++g) issue(g);
    }
    load_q(qr, q_b, min(TM, m), k, lane % G);
    __syncwarp();         // this warp's barriers, initialised, before a wait
    if (!valid) {
      for (int x = lane; x < m * (r1 - r0); x += 32)
        o_b[(x / (r1 - r0)) * k + r0 + x % (r1 - r0)] =
            __int_as_float(0x7fc00000);
      return;
    }
    for (int g = 0; g < n_copies; ++g) {
      const int tile = g / n_ch, i0 = r0 + (g % n_ch) * kRingRows;
      const int m0 = tile * TM, tm = min(TM, m - m0);
      if (g % n_ch == 0 && g > 0) load_q(qr, q_b + m0 * k, tm, k, lane % G);
      tc::mbar_wait(bar + 8 * (g % kRingStages), (g / kRingStages) & 1);
      const int i1 = min(r1, i0 + kRingRows);
      answer_steps<KS, TM, VEC, kRingRows / RS>(
          ring + (g % kRingStages) * kRingRows * k, i0, RS,
          (i1 - i0 + RS - 1) / RS, i1, qr, o_b + m0 * k, tm, k, lane);
      __syncwarp();                 // the stage is free once the warp is done
      if (lane == 0 && g + kRingStages < n_copies) issue(g + kRingStages);
    }
  }
}

// B4 (INDEXED) and B5 for odd k, the direct-load route. c: (n_states, k,
// k); rows: (b,) int32 (INDEXED); q, o: (b, m, k). KC = lane chunks per
// state row (KC · 32 >= k).
template <int TM, int KC, bool INDEXED>
__global__ void __launch_bounds__(kThreads)
mass_lookup_direct(const float* __restrict__ c, const int* __restrict__ rows,
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

// o[col] = the sum over w < kWarps of part[w·dv + col], in a fixed order:
// G threads a column (G = 256 / dv rounded down to a power of two, at most
// kWarps), each summing kWarps / G partials in turn, then a butterfly of
// G lanes; so 100 columns take 200 threads, not 100 chains of 8.
template <typename T>
__device__ __forceinline__ void sum_partials(const float* part, int dv,
                                             T* o_n) {
  const int g = dv <= 32 ? 8 : dv <= 64 ? 4 : dv <= 128 ? 2 : 1;
  const int col = threadIdx.x / g, h = threadIdx.x % g;   // dv·g <= 256
  float sum = 0.f;
  if (col < dv)
    for (int w = h * (kWarps / g); w < (h + 1) * (kWarps / g); ++w)
      sum += part[w * dv + col];
  for (int off = 1; off < g; off <<= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (h == 0 && col < dv) o_n[col] = from_float<T>(sum);
}

// B6 for dk·dv % 4 == 0 and states of at most kDecodeResident floats, the
// bulk route. s: (n, dk, dv) fp32, 16-byte aligned, updated in place; q,
// k: (n, dk); v, o: (n, dv). One block per state; KC = 32-column slices
// of a state row (32·KC >= dv).
template <typename T, int KC>
__global__ void __launch_bounds__(kThreads)
decode_bulk(float* __restrict__ s, const T* __restrict__ q,
            const T* __restrict__ k, const T* __restrict__ v,
            T* __restrict__ o, int dk, int dv) {
  constexpr int U = 8 / KC;                      // rows a lane holds at once
  extern __shared__ __align__(16) float smem[];  // the state, in place
  float* const part = smem + dk * dv;            // o's partial sums
  const int n = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t bar = tc::smem_u32(part + kWarps * dv) + 8 * warp;
  float* const s_n = s + static_cast<size_t>(n) * dk * dv;

  // this warp's rows [r0, r1), in steps of rs rows (a multiple of 16
  // bytes), by one bulk copy
  const int rs = dv % 4 == 0 ? 1 : dv % 2 == 0 ? 2 : 4;
  int r0, r1;
  warp_rows(dk, rs, warp, r0, r1);
  if (lane == 0) {
    tc::mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (r1 > r0)
      copy_rows(bar, smem + r0 * dv, s_n + r0 * dv, (r1 - r0) * dv * 4);
  }
  // while the copy flies: lane i holds q and k of the warp's row r0 + i
  // (a warp has at most 32 rows), and v of its columns lane + 32j
  const bool mine = r0 + lane < r1;
  const float q_l = mine ? to_float(q[static_cast<size_t>(n) * dk + r0 + lane])
                         : 0.f;
  const float k_l = mine ? to_float(k[static_cast<size_t>(n) * dk + r0 + lane])
                         : 0.f;
  float vr[KC], acc[KC];
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    const int col = lane + 32 * j;
    vr[j] = col < dv ? to_float(v[static_cast<size_t>(n) * dv + col]) : 0.f;
    acc[j] = 0.f;
  }
  __syncwarp();         // the barrier, initialised, before the wait

  if (r1 > r0) {
    tc::mbar_wait(bar, 0);
    for (int b = r0; b < r1; b += U) {
      float x[U][KC];   // all U rows' loads before any store
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          const int col = lane + 32 * j;
          if (b + u < r1 && col < dv) x[u][j] = smem[(b + u) * dv + col];
        }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float ka = __shfl_sync(0xffffffffu, k_l, (b + u - r0) & 31);
        const float qa = __shfl_sync(0xffffffffu, q_l, (b + u - r0) & 31);
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          const int col = lane + 32 * j;
          if (b + u < r1 && col < dv) {
            const float y = __fadd_rn(x[u][j], __fmul_rn(ka, vr[j]));
            smem[(b + u) * dv + col] = y;
            acc[j] = fmaf(qa, y, acc[j]);
          }
        }
      }
    }
    tc::fence_async();  // this lane's writes, seen by the bulk copy
    __syncwarp();
    if (lane == 0) {    // the rows back, while other warps' copies land
      tc::bulk_store(s_n + r0 * dv, tc::smem_u32(smem + r0 * dv),
                     (r1 - r0) * dv * 4);
      tc::bulk_commit();
    }
  }
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    const int col = lane + 32 * j;
    if (col < dv) part[warp * dv + col] = acc[j];
  }
  __syncthreads();
  sum_partials(part, dv, o + static_cast<size_t>(n) * dv);
  if (lane == 0) tc::bulk_wait_read<0>();  // the stores have read the state
}

// B6 for any shape, the direct route. s: (n, dk, dv) fp32, updated in
// place; q, k: (n, dk); v, o: (n, dv). One block per state; thread (tx,
// ty) updates columns tx + 32j (j < KC) of rows ty, ty + 8, ... R rows at
// a time, all R rows' loads issued before any store.
template <typename T, int KC, int R>
__global__ void __launch_bounds__(kThreads, 2)   // two blocks an SM
decode_direct(float* __restrict__ s, const T* __restrict__ q,
              const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ o, int dk, int dv) {
  __shared__ float qs[kMaxK], ks[kMaxK];
  __shared__ float part[kWarps * kMaxK];

  const int n = blockIdx.x;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  for (int a = threadIdx.x; a < dk; a += kThreads) {
    qs[a] = to_float(q[static_cast<size_t>(n) * dk + a]);
    ks[a] = to_float(k[static_cast<size_t>(n) * dk + a]);
  }
  float vr[KC], acc[KC];
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    const int col = tx + 32 * j;
    vr[j] = col < dv ? to_float(v[static_cast<size_t>(n) * dv + col]) : 0.f;
    acc[j] = 0.f;
  }
  __syncthreads();

  float* s_n = s + static_cast<size_t>(n) * dk * dv;
  for (int a0 = ty; a0 < dk; a0 += kWarps * R) {
    float x[R][KC];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const int a = a0 + kWarps * r, col = tx + 32 * j;
        if (a < dk && col < dv)
          x[r][j] = s_n[static_cast<size_t>(a) * dv + col];
      }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int a = a0 + kWarps * r;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const int col = tx + 32 * j;
        if (a < dk && col < dv) {
          const float y = __fadd_rn(x[r][j], __fmul_rn(ks[a], vr[j]));
          s_n[static_cast<size_t>(a) * dv + col] = y;
          acc[j] = fmaf(qs[a], y, acc[j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    const int col = tx + 32 * j;
    if (col < dv) part[ty * dv + col] = acc[j];
  }
  __syncthreads();
  sum_partials(part, dv, o + static_cast<size_t>(n) * dv);
}

template <int TM, int KC>
void launch_direct(const float* c, const int* rows, const float* q, float* o,
                   int n_states, int b, int m, int k, cudaStream_t stream) {
  const dim3 grid(b, (m + TM - 1) / TM), block(kThreads);
  if (rows)
    mass_lookup_direct<TM, KC, true>
        <<<grid, block, 0, stream>>>(c, rows, q, o, n_states, m, k);
  else
    mass_lookup_direct<TM, KC, false>
        <<<grid, block, 0, stream>>>(c, rows, q, o, n_states, m, k);
}

template <int TM>
int launch_direct_tile(const float* c, const int* rows, const float* q,
                       float* o, int n_states, int b, int m, int k,
                       cudaStream_t stream) {
  const int kc = (k + 31) / 32;
  if (kc <= 1) launch_direct<TM, 1>(c, rows, q, o, n_states, b, m, k, stream);
  else if (kc <= 2) launch_direct<TM, 2>(c, rows, q, o, n_states, b, m, k, stream);
  else if (kc <= 4) launch_direct<TM, 4>(c, rows, q, o, n_states, b, m, k, stream);
  else launch_direct<TM, 8>(c, rows, q, o, n_states, b, m, k, stream);
  return 0;
}

template <int KS, int TM, int VEC>
int launch_bulk(const float* c, const int* rows, const float* q, float* o,
                int n_states, int b, int m, int k, cudaStream_t stream) {
  const auto kernel = rows ? mass_lookup_bulk<KS, TM, VEC, true>
                           : mass_lookup_bulk<KS, TM, VEC, false>;
  // the opt-in to the most dynamic shared memory this instantiation takes
  // (more than 48 KiB for K > 100), on every launch: the attribute is the
  // current device's
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bulk_smem_bytes(32 * KS));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<b, kThreads, bulk_smem_bytes(k), stream>>>(c, rows, q, o,
                                                       n_states, m, k);
  return 0;
}

template <int TM>
int launch_bulk_tile(const float* c, const int* rows, const float* q,
                     float* o, int n_states, int b, int m, int k,
                     cudaStream_t stream) {
  // 16-byte shared loads where a row is a whole number of them and the
  // state is resident; 8-byte ones otherwise (the ring keeps 8-byte loads:
  // at KS = 8 a lane's 16-byte columns of four queries would take 128
  // registers)
  if (k % 4 == 0 && k <= kResidentK) {
    if (k <= 32) return launch_bulk<1, TM, 4>(c, rows, q, o, n_states, b, m, k, stream);
    if (k <= 64) return launch_bulk<2, TM, 4>(c, rows, q, o, n_states, b, m, k, stream);
    return launch_bulk<4, TM, 4>(c, rows, q, o, n_states, b, m, k, stream);
  }
  if (k <= 32) return launch_bulk<1, TM, 2>(c, rows, q, o, n_states, b, m, k, stream);
  if (k <= 64) return launch_bulk<2, TM, 2>(c, rows, q, o, n_states, b, m, k, stream);
  if (k <= 128) return launch_bulk<4, TM, 2>(c, rows, q, o, n_states, b, m, k, stream);
  return launch_bulk<8, TM, 2>(c, rows, q, o, n_states, b, m, k, stream);
}

template <typename T, int KC>
int launch_decode(float* s, const void* q, const void* k, const void* v,
                  void* o, int n, int dk, int dv, bool bulk,
                  cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  if (!bulk) {
    constexpr int R = KC > 4 ? 4 : 8;    // at most 32 values a thread
    decode_direct<T, KC, R><<<n, kThreads, 0, stream>>>(s, qt, kt, vt, ot,
                                                         dk, dv);
    return 0;
  }
  // the opt-in to the most dynamic shared memory this instantiation takes
  const auto kernel = decode_bulk<T, KC>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      decode_smem_bytes(kDecodeResident, 32 * KC));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n, kThreads, decode_smem_bytes(dk * dv, dv), stream>>>(
      s, qt, kt, vt, ot, dk, dv);
  return 0;
}

template <typename T>
int launch_decode_cols(float* s, const void* q, const void* k, const void* v,
                       void* o, int n, int dk, int dv, bool bulk,
                       cudaStream_t stream) {
  const int kc = (dv + 31) / 32;
  if (kc <= 1) return launch_decode<T, 1>(s, q, k, v, o, n, dk, dv, bulk, stream);
  if (kc <= 2) return launch_decode<T, 2>(s, q, k, v, o, n, dk, dv, bulk, stream);
  if (kc <= 4) return launch_decode<T, 4>(s, q, k, v, o, n, dk, dv, bulk, stream);
  return launch_decode<T, 8>(s, q, k, v, o, n, dk, dv, bulk, stream);
}

}  // namespace

// B4 (rows != null) and B5 (rows == null: row b reads state b, and
// n_states must equal b). c: (n_states, k, k), q and o: (b, m, k), fp32;
// rows: (b,) int32. All contiguous, on the current device; 1 <= k <= 256.
// Even k takes the bulk route: c 16-byte aligned (the size of a state,
// k·k·4 bytes, is then a multiple of 16), q 16-byte (k % 4 == 0) or 8-byte
// aligned; odd k the direct route.
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
  int err;
  if (k % 2 == 0) {
    if (reinterpret_cast<uintptr_t>(c) % 16 ||
        reinterpret_cast<uintptr_t>(q) % (k % 4 ? 8 : 16) ||
        reinterpret_cast<uintptr_t>(o) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
    if (m == 1) err = launch_bulk_tile<1>(cf, r, qf, of, n_states, b, m, k, st);
    else err = launch_bulk_tile<4>(cf, r, qf, of, n_states, b, m, k, st);
  } else if (m == 1) {
    err = launch_direct_tile<1>(cf, r, qf, of, n_states, b, m, k, st);
  } else {
    err = launch_direct_tile<4>(cf, r, qf, of, n_states, b, m, k, st);
  }
  return err ? err : static_cast<int>(cudaGetLastError());
}

// B6. s: (n, dk, dv) fp32, updated in place; q, k: (n, dk) and v: (n, dv)
// in fp32 (bf16 == 0) or bf16 (bf16 == 1); o: (n, dv) in v's type. All
// contiguous, on the current device; 1 <= dk, dv <= 256. A state of
// dk·dv % 4 == 0 and at most kDecodeResident floats takes the bulk route
// (s 16-byte aligned: the size of a state, dk·dv·4 bytes, is then a
// multiple of 16); any other the direct route.
extern "C" int lookup_decode(void* s, const void* q, const void* k,
                             const void* v, void* o, int n, int dk, int dv,
                             int bf16, void* stream) {
  if (n <= 0 || dk <= 0 || dv <= 0 || dk > kMaxK || dv > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sf = static_cast<float*>(s);
  const bool bulk = decode_bulk_route(dk, dv);
  if (bulk && reinterpret_cast<uintptr_t>(s) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int err =
      bf16 ? launch_decode_cols<__nv_bfloat16>(sf, q, k, v, o, n, dk, dv,
                                               bulk, st)
           : launch_decode_cols<float>(sf, q, k, v, o, n, dk, dv, bulk, st);
  return err ? err : static_cast<int>(cudaGetLastError());
}
