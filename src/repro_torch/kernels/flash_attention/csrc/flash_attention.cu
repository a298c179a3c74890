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
// and o = acc / l (l = 0 taken as 1) written in the input's type. Given
// an lse pointer, each query's log-sum-exp m + log l (in the units of
// the scaled scores, l = 0 taken as 1) is written beside o in fp32, from
// the same registers that normalise o: JAX's _flash_fwd_impl returns it
// for the softmax backward. A null pointer leaves the launch as it was.
//
// K and V are read by kv head. q holds rows·T rows of D, k and v
// (rows / heads · kv_heads)·S, with the flat heads of the (G, Hkv)
// flattening h = g·Hkv + j: q row b·H + h reads kv row b·Hkv + h mod Hkv.
// kv_heads = heads is the plain one-to-one call; no broadcast copy of K
// and V is made for grouped-query attention.
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
// Bound. At the prefill main path's shape (B 8 × H 16 query rows over
// 8 kv heads, T = S = 512, D = 128, bf16) the causal pairs need 2·D
// operations each for q·k and 2·D for p·v: 8.61 GFLOP, 8.70 µs on the
// bf16 tensor cores (989 TFLOP/s), against 50.3 MB of q, o and the kv
// heads' k and v, 15.0 µs at 3.35 TB/s: bytes bound it.
//
// Two routes, by type.
//
// bf16 (the main path's): the tensor cores, through wgmma.
// - Grid. Persistent: one block of three warpgroups per SM walks the
//   work tiles (one query row, 128 queries), the longest query tiles
//   first, so that a tile's loads run during the previous tile's work.
// - Loads. One producer thread loads each work tile's Q once, into one of
//   two buffers, then each 64-key tile of K and V of its kv row into a
//   ring of kStages stages, all by TMA: 3-D tensor maps, 128-byte
//   swizzle, rows past T or S and columns past D zero-filled. A stage
//   has a "full" mbarrier and an "empty" one that the 256 consumer
//   threads arrive on when they are done with it.
// - Products. Two consumer warpgroups own 64 queries each. For key tile j
//   a warpgroup issues S = Q K_jᵀ (m64n64k16, both from shared memory,
//   K-major) together with the previous key tile's O += P V (P as the
//   register A operand, V from shared memory as an MN-major B, one
//   m64n64k16 per 64 columns of D), waits for S only, and runs tile j's
//   online softmax while P V runs. The two warpgroups take turns at the
//   tensor cores (a named barrier each), so that one's softmax also
//   overlaps the other's products. Q stays in shared memory: beside S,
//   P and O it does not fit the 168 registers a thread of a 384-thread
//   block has at D = 128 (setmaxnreg does not raise what ptxas
//   allocates; ptxas spills and serializes the wgmmas). So Q Kᵀ reads
//   both operands from shared memory, whose port (128 bytes a clock) is
//   then as busy as the tensor cores.
// - Softmax, in registers. A thread holds 16 scores of each of two rows;
//   a row's max takes two shuffles within its quad, its sum stays per
//   thread until the end. The max is kept in raw scores and
//   c = |scale|·log2 e folded into one FFMA per score, so each p is one
//   ex2.approx (a negative scale flips Q's signs, exactly); denormal p
//   flush to 0, 2^-126 below the row's largest p = 1. The mask is applied
//   only on key tiles that cross the diagonal or s_real.
// - Output. o = O / l is staged in the warpgroup's rows of its Q buffer
//   and written by a TMA store (rows past T and columns past D left
//   out); the buffer goes back to the producer once the store has read
//   it.
// - Numbers. P is rounded to bf16 before P·V, as the JAX package's oracle
//   does (repro/kernels/flash_attention/ref.py casts the probabilities to
//   v's type; the port's copy is ref.flash_attention_ref); m, l and O
//   stay in fp32. D = 16 and 64 use one 64-column block (the columns past
//   D are zeros), D = 96, 112 and 128 two. At D = 96 (112) the second
//   block's columns 96-127 (112-127) are zero-filled on load, so Q Kᵀ
//   runs 6 (7) k16 steps and its P V block holds zeros there, which the
//   TMA store leaves out (the row strides of 192 and 224 bytes are
//   multiples of 16, as TMA needs).
// - A barrier wait that lasts seconds traps, so that a lost phase fails
//   the launch instead of hanging the card.
//
// fp32 (the correctness slices'): fp32 FMAs on the CUDA cores, where
// tensor cores would round. A block of 256 threads owns one row and a
// tile of 64 queries. The query tile stays in shared memory as fp32 for
// the whole loop; each 64-key tile of K and V is staged in shared memory
// (113 KiB in all at D = 128, two blocks per SM). The threads form a
// 16×16 grid: thread (ti, tj) owns queries ti + 16r (r < 4), and within
// a key tile keys tj + 16c (c < 4) of the scores and columns tj + 16c
// (c < D/16) of acc, so the 16 threads that share a query are one
// half-warp and reduce its max and sum by shuffles; (m, l, acc) stay in
// registers. The scores P go through shared memory to the P·V product.
// Shared rows of Q, K and P are padded by one word so that the warps'
// reads do not conflict.
//
// Both launch on the caller's stream and allocate nothing.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas body's NEG_INF

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBM = 128;                       // queries per work tile
constexpr int kBN = 64;                        // keys per tile
constexpr int kStages = 4;                     // K/V ring depth
constexpr int kConsumers = 256;                // two warpgroups
constexpr int kThreads = kConsumers + 128;     // and the producer's
constexpr int kRowBytes = 128;                 // 64 bf16: one swizzle row
constexpr int kQBlock = kBM * kRowBytes;       // Q, one 64-column block
constexpr int kKVBlock = kBN * kRowBytes;      // K or V, one 64-column block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory, from a 1024-byte aligned base (the swizzle's period):
// Q [2 buffers][DC][128 rows][64], then K and V [kStages][DC][64 rows][64],
// each 64-column block as TMA writes it with the 128-byte swizzle; then
// the mbarriers: Q full ×2, Q empty ×2, K/V full ×kStages, empty
// ×kStages.
template <int DC>
struct Smem {
  static constexpr int q = 0;
  static constexpr int k = q + 2 * DC * kQBlock;
  static constexpr int v = k + kStages * DC * kKVBlock;
  static constexpr int bars = v + kStages * DC * kKVBlock;
  static constexpr int bytes = bars + (4 + 2 * kStages) * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// returns once the phase of parity `parity` has completed. A wait of 2^34
// clocks (seconds) means a lost phase: it traps, so that the launch fails
// with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// one box of a 3-D tensor map (coordinates innermost first) into shared
// memory, completing `bytes` of the barrier's transaction count
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// one box of a 3-D tensor map from shared memory, as a bulk group of its
// own; bulk_wait_read returns once the issuing thread's groups have read
// shared memory, bulk_wait once they are written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle. K-major operands
// (Q, K) step 8-row groups by sbo = 1024 bytes and ignore lbo; the
// MN-major V has one 64-wide swizzle atom per instruction, so only its
// 8-row step along K (1024 bytes) is read, whichever field holds it.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// returns once at most N of this warpgroup's committed groups are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving register reads and writes across the
// asynchronous window between a wgmma's issue and its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (64×64 fp32) += A (64×16, shared, K-major) · B (16×64, shared,
// K-major); scale_d = 0: d = A·B, the accumulator's old values ignored
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64×64 fp32) += A (64×16 bf16, registers) · B (16×64, shared,
// MN-major: the V tile)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t x;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(x) : "r"(addr));
  return x;
}

// 2^x in one MUFU op (denormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the two consumer warpgroups take turns at the tensor cores: each waits
// on its own named barrier (1 + wg) before it issues a product and
// arrives on the other's after, so one warpgroup's softmax runs while
// the other's products do
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;" ::"r"(2 - wg) : "memory");
}

// One key tile's online softmax for this thread's rows r0 and r0 + 8
// (h = 0, 1), in place: the raw scores q·k in sc become the tile's
// probabilities p. The running max m is kept in raw units and
// c = |scale|·log2 e (a negative scale flips Q's signs instead), so each
// p is one FFMA and one ex2: p = 2^(c·s - c·m). With MASK, masked keys
// are left out of the max and get p = 0, which is what the Pallas body's
// -1e30 gives once a row has a visible key. Updates m and the
// thread-partial sum l and returns the rescale factor alpha of each row.
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float c, int k0, int qi0, int cl,
                                             int t_off, int s_real) {
  auto seen = [&](int x) {
    const int key = k0 + 8 * (x / 4) + cl + (x & 1);
    return key <= qi0 + 8 * ((x >> 1) & 1) + t_off && key < s_real;
  };
  float mc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx0 = m[h], mx1 = kNegInf;   // two chains: half the latency
#pragma unroll
    for (int g = 0; g < 8; ++g)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * g + 2 * h + e;
        const float v = !MASK || seen(x) ? sc[x] : kNegInf;
        if (g % 2) mx1 = fmaxf(mx1, v); else mx0 = fmaxf(mx0, v);
      }
    float mx = fmaxf(mx0, mx1);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    alpha[h] = ex2((m[h] - mx) * c);
    m[h] = mx;
    mc[h] = mx * c;
  }
  float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    const int h = (x >> 1) & 1;
    const float px = ex2(fmaf(sc[x], c, -mc[h]));
    sc[x] = !MASK || seen(x) ? px : 0.f;
    sum[h][(x >> 2) & 1] += sc[x];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    l[h] = l[h] * alpha[h] + (sum[h][0] + sum[h][1]);
}

// P in bf16 as wgmma's A operand: k16 step kk holds key columns
// 16kk..16kk+15, which are the accumulator's registers 8kk..8kk+7
__device__ __forceinline__ void pack_p(const float (&sc)[32],
                                       uint32_t (&p)[4][4]) {
#pragma unroll
  for (int x = 0; x < 32; x += 2)
    p[x / 8][(x % 8) / 2] = pack_bf16(sc[x], sc[x + 1]);
}

// Persistent: grid min(SMs, work tiles); block b takes work tiles b,
// b + gridDim.x, ... of the rows·ceil(t_len / kBM) (row, 128-query tile)
// pairs, the longest query tiles first. block kThreads; dynamic shared
// memory Smem<DC>::bytes. Tensor maps (D, T, rows) for q and o and (D, S,
// kv rows) for k and v, boxes (64, kBM, 1) for q, (64, 64, 1) for o (a
// warpgroup's rows) and (64, kBN, 1) for k and v.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const __grid_constant__ CUtensorMap to,
             float* __restrict__ lse, int rows, int t_len, int heads,
             int kv_heads, int t_off, int s_real, float scale_log2) {
  constexpr int DC = (D + 63) / 64;         // 64-column blocks of D
  constexpr int QK_STEPS = (D + 15) / 16;   // k16 steps of Q Kᵀ
  using L = Smem<DC>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base + L::q, sk = base + L::k, sv = base + L::v;
  const uint32_t q_full = base + L::bars, q_empty = q_full + 16;
  const uint32_t full = q_empty + 16, empty = full + 8 * kStages;
  const int n_qt = (t_len + kBM - 1) / kBM;
  const int n_work = rows * n_qt;
  const int tid = threadIdx.x;

  // work tile w: its row, first query, kv row and key tiles (the tiles
  // after the one that holds key min(last query + t_off, s_real - 1) are
  // masked for all of its queries; see the header)
  struct Tile {
    int row, q0, kv_row, n_kt;
  };
  auto tile = [&](int w) {
    Tile t;
    t.row = w % rows;
    t.q0 = (n_qt - 1 - w / rows) * kBM;
    t.kv_row = t.row / heads * kv_heads + t.row % kv_heads;
    t.n_kt = min(min(t.q0 + kBM, t_len) - 1 + t_off, s_real - 1) / kBN + 1;
    return t;
  };

  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(q_full + 8 * b, 1);
      mbar_init(q_empty + 8 * b, 2);  // one thread of each warpgroup
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warpgroup: one thread loads
    if (tid == kConsumers) {
      int it = 0;  // K/V tiles loaded so far: the ring's position
      for (int n = 0, w = blockIdx.x; w < n_work; ++n, w += gridDim.x) {
        const Tile t = tile(w);
        const int qb = n % 2;  // Q is double-buffered across work tiles
        mbar_wait(q_empty + 8 * qb, ((n / 2) & 1) ^ 1);
        mbar_expect_tx(q_full + 8 * qb, DC * kQBlock);
        for (int c = 0; c < DC; ++c)
          tma_load(sq + (qb * DC + c) * kQBlock, &tq, q_full + 8 * qb,
                   64 * c, t.q0, t.row);
        for (int j = 0; j < t.n_kt; ++j, ++it) {
          const int s = it % kStages;
          mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, 2 * DC * kKVBlock);
          for (int c = 0; c < DC; ++c) {
            tma_load(sk + (s * DC + c) * kKVBlock, &tk, full + 8 * s, 64 * c,
                     j * kBN, t.kv_row);
            tma_load(sv + (s * DC + c) * kKVBlock, &tv, full + 8 * s, 64 * c,
                     j * kBN, t.kv_row);
          }
        }
      }
    }
    return;
  }

  // -- the consumer warpgroups -----------------------------------------------
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  // the accumulator layout: this thread holds rows r0 and r0 + 8 of the
  // warpgroup's 64, and in each 8-column group columns cl and cl + 1
  const int r0 = warp * 16 + lane / 4, cl = 2 * (lane % 4);
  const float c = fabsf(scale_log2);

  float acc[DC][32], sc[32], m[2], l[2], alpha[2];
  uint32_t p[4][4];
  int it = 0;  // K/V tiles consumed so far: the ring's position
  // The Q buffer whose O staging the last work tile's TMA store still
  // reads; the warpgroup's lead thread gives it back to the producer
  // during the next work tile, so that the wait is off the critical path
  int released = -1;
  auto release_q = [&]() {
    if (released >= 0 && tid == 128 * wg) {
      bulk_wait_read();
      mbar_arrive(q_empty + 8 * released);
    }
    released = -1;
  };
  // The turns alternate strictly, warpgroup 0 first, across work tiles:
  // both warpgroups take n_kt + 1 turns in each.
  if (wg == 1) turn_pass(1);
  for (int n = 0, w = blockIdx.x; w < n_work; ++n, w += gridDim.x) {
    const Tile t = tile(w);
    const int qb = n % 2;
    const uint32_t sq_b = sq + qb * DC * kQBlock;
    const int qw0 = t.q0 + 64 * wg;         // this warpgroup's first query
    const int n_own =                       // its key tiles (0: no query)
        qw0 < t_len
            ? min(min(qw0 + 63, t_len - 1) + t_off, s_real - 1) / kBN + 1
            : 0;

    // Under a negative scale Q's signs are flipped in shared memory
    // (exact), so that c > 0
    mbar_wait(q_full + 8 * qb, (n / 2) & 1);
    if (scale_log2 < 0.f) {
      for (int e = tid; e < DC * kQBlock / 4; e += kConsumers)
        asm volatile("st.shared.b32 [%0], %1;" ::"r"(sq_b + 4 * e),
                     "r"(lds32(sq_b + 4 * e) ^ 0x80008000u)
                     : "memory");
      // the writes seen by wgmma (the async proxy), then by both
      // warpgroups
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync 3, 256;" ::: "memory");
    }

    // S = Q Kᵀ of the key tile in stage s, and O += P V of the key tile in
    // stage s; each issue is fenced and committed as a group of its own,
    // and its register operands fenced after the commit
    auto issue_qk = [&](int s) {
      // Q's descriptors from one base made opaque at each issue: as loop
      // invariants the QK_STEPS of them (two registers each) would stay
      // live across the key loop, past the 168 registers a thread has at
      // D = 112 and 128, and ptxas would spill. A descriptor's address
      // field is addr >> 4 (below 2^14 in shared memory), so adding an
      // offset's >> 4 gives the descriptor of addr + offset
      uint64_t dq = desc(sq_b + 64 * wg * kRowBytes, 16, 1024);
      asm volatile("" : "+l"(dq));
      fence_regs(sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < QK_STEPS; ++kk)
        wgmma_ss(sc, dq + (((kk / 4) * kQBlock + (kk % 4) * 32) >> 4),
                 desc(sk + (s * DC + kk / 4) * kKVBlock + (kk % 4) * 32, 16,
                      1024),
                 kk > 0);
      wg_commit();
      fence_regs(sc);
    };
    auto issue_pv = [&](int s) {
#pragma unroll
      for (int cb = 0; cb < DC; ++cb) fence_regs(acc[cb]);
      fence_regs(p);
      wg_fence();
#pragma unroll
      for (int cb = 0; cb < DC; ++cb)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(acc[cb], p[kk],
                      desc(sv + (s * DC + cb) * kKVBlock + kk * 16 * kRowBytes,
                           1024, 1024));
      wg_commit();
#pragma unroll
      for (int cb = 0; cb < DC; ++cb) fence_regs(acc[cb]);
      fence_regs(p);
    };
    auto softmax = [&](int j) {  // masked only where the key tile crosses
                                 // the diagonal or s_real
      const int k0 = j * kBN;
      if (k0 + kBN - 1 > qw0 + t_off || k0 + kBN > s_real)
        softmax_tile<true>(sc, m, l, alpha, c, k0, qw0 + r0, cl, t_off,
                           s_real);
      else
        softmax_tile<false>(sc, m, l, alpha, c, k0, qw0 + r0, cl, t_off,
                            s_real);
    };

#pragma unroll
    for (int cb = 0; cb < DC; ++cb)
#pragma unroll
      for (int x = 0; x < 32; ++x) acc[cb][x] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = kNegInf;
      l[h] = 0.f;
    }

    // Each turn at the tensor cores issues S = Q K_jᵀ together with the
    // previous key tile's O += P V, so that tile j's softmax runs while
    // P V does.
    if (n_own > 0) {
      mbar_wait(full + 8 * (it % kStages), (it / kStages) & 1);
      turn_wait(wg);
      issue_qk(it % kStages);
      turn_pass(wg);
      release_q();
      wg_wait<0>();
      softmax(0);                       // alpha = 0: acc is still 0
      pack_p(sc, p);
      for (int j = 1; j < n_own; ++j) {
        const int s = (it + j) % kStages, s_prev = (it + j - 1) % kStages;
        mbar_wait(full + 8 * s, ((it + j) / kStages) & 1);
        turn_wait(wg);
        issue_qk(s);
        issue_pv(s_prev);
        turn_pass(wg);
        wg_wait<1>();                   // S is in; P V may still run
        softmax(j);
        wg_wait<0>();
#pragma unroll
        for (int cb = 0; cb < DC; ++cb) fence_regs(acc[cb]);
        fence_regs(p);
        mbar_arrive(empty + 8 * s_prev);
#pragma unroll
        for (int cb = 0; cb < DC; ++cb)
#pragma unroll
          for (int x = 0; x < 32; ++x) acc[cb][x] *= alpha[(x >> 1) & 1];
        pack_p(sc, p);
      }
      const int s_last = (it + n_own - 1) % kStages;
      turn_wait(wg);
      issue_pv(s_last);
      turn_pass(wg);
      wg_wait<0>();
#pragma unroll
      for (int cb = 0; cb < DC; ++cb) fence_regs(acc[cb]);
      mbar_arrive(empty + 8 * s_last);
    }
    release_q();
    // the key tiles none of this warpgroup's queries sees: keep the
    // stages' phases and the turns in step (both warpgroups take
    // n_kt + 1 turns)
    for (int j = n_own; j < t.n_kt; ++j) {
      mbar_wait(full + 8 * ((it + j) % kStages), ((it + j) / kStages) & 1);
      mbar_arrive(empty + 8 * ((it + j) % kStages));
      turn_wait(wg);
      turn_pass(wg);
    }
    if (n_own == 0) {
      turn_wait(wg);
      turn_pass(wg);
    }
    it += t.n_kt;

    // -- o = acc / l, staged in this warpgroup's 64 rows of the Q buffer
    // (Q Kᵀ is done with them) in TMA's swizzled layout and stored by TMA,
    // which leaves out the rows past t_len and the columns past D; the
    // buffer goes back to the producer once the store has read it, during
    // the next work tile --------------------------------------------------
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
    // lse = ln Σ_j exp(scale·s_j) = (c·m + log2 l)·ln 2 with m the raw
    // max: one lane of each quad writes its two rows
    if (lse != nullptr && n_own > 0 && cl == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qi = qw0 + r0 + 8 * h;
        if (qi < t_len)
          lse[static_cast<size_t>(t.row) * t_len + qi] =
              (m[h] * c + log2f(l[h] == 0.f ? 1.f : l[h])) * kLn2;
      }
    const int lead = 128 * wg;                 // the warpgroup's first thread
    if (n_own > 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 64 * wg + r0 + 8 * h;
        const float inv = 1.f / (l[h] == 0.f ? 1.f : l[h]);
#pragma unroll
        for (int cb = 0; cb < DC; ++cb)
#pragma unroll
          for (int g = 0; g < 8; ++g)
            asm volatile("st.shared.b32 [%0], %1;" ::"r"(
                             sq_b + cb * kQBlock + r * kRowBytes +
                             ((g ^ (r % 8)) * 16) + cl * 2),
                         "r"(pack_bf16(acc[cb][4 * g + 2 * h] * inv,
                                       acc[cb][4 * g + 2 * h + 1] * inv))
                         : "memory");
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    asm volatile("bar.sync %0, 128;" ::"r"(4 + wg) : "memory");
    if (tid == lead && n_own > 0)
      for (int cb = 0; cb < DC; ++cb)
        tma_store(&to, sq_b + cb * kQBlock + 64 * wg * kRowBytes, 64 * cb,
                  qw0, t.row);
    released = qb;  // given back once the store has read it (see above)
  }
  if (tid == 0 || tid == 128) {
    bulk_wait();
    if (released >= 0) mbar_arrive(q_empty + 8 * released);
  }
  if (wg == 0) turn_wait(0);  // the turn warpgroup 1 passed first
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (the library
// does not link libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// (d, n, rows) bf16, rows of n·d contiguous; box (64, box_n, 1), 128-byte
// swizzle, out-of-bounds elements read as zero
int tensor_map(CUtensorMap* map, const void* ptr, int d, int n, int rows,
               int box_n) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(n) * d * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_n), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  // CUDA_ERROR_INVALID_VALUE and the like, kept apart from runtime codes
  return res == CUDA_SUCCESS ? 0 : 10000 + static_cast<int>(res);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int rows, int heads, int kv_heads, int t_len, int s_len,
           int t_off, int s_real, float scale, cudaStream_t stream) {
  constexpr int kSmem = Smem<(D + 63) / 64>::bytes;
  auto kernel = flash_fwd_tc<D>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int kv_rows = rows / heads * kv_heads;
  CUtensorMap tq, tk, tv, to;
  int err = tensor_map(&tq, q, D, t_len, rows, kBM);
  if (!err) err = tensor_map(&tk, k, D, s_len, kv_rows, kBN);
  if (!err) err = tensor_map(&tv, v, D, s_len, kv_rows, kBN);
  if (!err) err = tensor_map(&to, o, D, t_len, rows, 64);
  if (err) return err;
  // the SM count of each device, asked once
  static int sms_of[64] = {};
  int device = 0;
  cudaError_t cerr = cudaGetDevice(&device);
  if (cerr == cudaSuccess && device < 64 && !sms_of[device])
    cerr = cudaDeviceGetAttribute(&sms_of[device],
                                  cudaDevAttrMultiProcessorCount, device);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int sms = device < 64 ? sms_of[device] : 1;
  const long long n_work =
      static_cast<long long>(rows) * ((t_len + kBM - 1) / kBM);
  const dim3 grid(static_cast<unsigned>(n_work < sms ? n_work : sms)),
      block(kThreads);
  kernel<<<grid, block, kSmem, stream>>>(tq, tk, tv, to, lse, rows, t_len,
                                         heads, kv_heads, t_off, s_real,
                                         scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------
namespace fp32 {

constexpr int kGrid = 16;          // threads per side of the thread grid
constexpr int kThreads = kGrid * kGrid;
constexpr int kTq = 64;            // queries per block
constexpr int kTk = 64;            // keys per step
constexpr int kRm = kTq / kGrid;   // queries per thread
constexpr int kRn = kTk / kGrid;   // keys per thread and step

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
// smem_floats<D>() floats. q, o: (rows, t_len, D); k, v: (kv rows, s_len, D).
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_fp32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, int t_len, int s_len, int heads,
               int kv_heads, int t_off, int s_real, float scale) {
  static_assert(D % kGrid == 0, "D must be a multiple of 16");
  constexpr int LQ = D + 1, LP = kTk + 1, RD = D / kGrid;

  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTq * LQ;
  float* Vs = Ks + kTk * LQ;
  float* Ps = Vs + kTk * D;

  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTq;  // longest tiles first
  const size_t row = blockIdx.x;
  const size_t kv_row = row / heads * kv_heads + row % kv_heads;
  const float* __restrict__ Q = q + row * t_len * D;
  const float* __restrict__ K = k + kv_row * s_len * D;
  const float* __restrict__ V = v + kv_row * s_len * D;
  float* __restrict__ O = o + row * t_len * D;
  const int tid = threadIdx.x;
  const int ti = tid / kGrid, tj = tid % kGrid;

  for (int e = tid; e < kTq * D; e += kThreads) {
    const int r = e / D, c = e % D;
    Qs[r * LQ + c] =
        q0 + r < t_len ? Q[static_cast<size_t>(q0 + r) * D + c] : 0.f;
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
        kv = K[off];
        vv = V[off];
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
      O[static_cast<size_t>(i) * D + tj + c * kGrid] = acc[r][c] / denom;
    // m is in the units of the scaled scores here
    if (lse != nullptr && tj == 0) lse[row * t_len + i] = m[r] + logf(denom);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int rows, int heads, int kv_heads, int t_len, int s_len,
           int t_off, int s_real, float scale, cudaStream_t stream) {
  constexpr size_t kSmem = smem_floats<D>() * sizeof(float);
  auto kernel = flash_fwd_fp32<D>;
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
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, t_len,
      s_len, heads, kv_heads, t_off, s_real, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fp32

int launch_d(int bf16, const void* q, const void* k, const void* v, void* o,
             float* lse, int rows, int heads, int kv_heads, int t, int s,
             int d, int t_off, int s_real, float scale, cudaStream_t st) {
#define FA_LAUNCH(D)                                                        \
  return bf16 ? tc::launch<D>(q, k, v, o, lse, rows, heads, kv_heads, t, s, \
                              t_off, s_real, scale, st)                     \
              : fp32::launch<D>(q, k, v, o, lse, rows, heads, kv_heads, t,  \
                                s, t_off, s_real, scale, st)
  switch (d) {
    case 16:
      FA_LAUNCH(16);
    case 64:
      FA_LAUNCH(64);
    case 96:
      FA_LAUNCH(96);
    case 112:
      FA_LAUNCH(112);
    case 128:
      FA_LAUNCH(128);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FA_LAUNCH
}

}  // namespace

// B10. q, o: contiguous (rows, t, d); k, v: contiguous (rows / heads ·
// kv_heads, s, d), q row b·heads + h reading kv row b·kv_heads + h mod
// kv_heads; all of one type, fp32 (bf16 == 0) or bf16 (bf16 == 1), on the
// current device, 16-byte aligned; d in {16, 64, 96, 112, 128}. lse: null,
// or a contiguous fp32 (rows, t) that receives each query's log-sum-exp. Query
// i attends key j iff j <= i + t_off and j < s_real; requires t_off >= 0
// and 1 <= s_real <= s (see the header). Returns cudaGetLastError() after the
// launch, cudaErrorInvalidValue for arguments it does not take, or
// 10000 + the driver's CUresult when a tensor map cannot be made.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int rows,
                                   int heads, int kv_heads, int t, int s,
                                   int d, int t_off, int s_real, float scale,
                                   int bf16, void* lse, void* stream) {
  if (rows <= 0 || t <= 0 || s <= 0 || heads <= 0 || kv_heads <= 0 ||
      heads % kv_heads || rows % heads || t_off < 0 || s_real < 1 ||
      s_real > s || (t + fp32::kTq - 1) / fp32::kTq > 65535 ||
      static_cast<long long>(rows) * ((t + tc::kBM - 1) / tc::kBM) >
          2147483647ll ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_d(bf16, q, k, v, o, static_cast<float*>(lse), rows, heads,
                  kv_heads, t, s, d, t_off, s_real, scale,
                  static_cast<cudaStream_t>(stream));
}
