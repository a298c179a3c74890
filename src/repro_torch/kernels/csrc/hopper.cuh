// Hopper building blocks of the port's tensor-core sweeps and bulk copies,
// for sm_90a: linear_attention.cu (B2, B3), gated_linear_attention.cu (B8,
// B9) and lookup.cu (B4-B6) include this file. kernels/build.py names each
// library by a hash of its source and of every file the source includes,
// so an edit here rebuilds all three.
//
// - TMA: one thread loads a (64-column, 64-row) box of a 3-D tensor map
//   into shared memory with the 128-byte swizzle, completing its bytes on
//   an mbarrier; elements out of bounds read as zero. Or a run of
//   contiguous bytes, with no tensor map (bulk_load), and back to global
//   memory in bulk groups (bulk_store, bulk_commit, bulk_wait_read).
// - wgmma: m64n64k16 products of bf16 operands with fp32 accumulators,
//   both operands from swizzled shared memory (K-major or MN-major), or A
//   from registers.
// - A 64×64 score tile in the accumulator layout, masked to the causal
//   triangle and packed as the register A operand of the next product.
//
// flash_attention.cu (B10) keeps its own copies of some of these.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {
namespace tc {

constexpr int kTile = 64;                    // tokens per tile: wgmma's M
constexpr int kThreads = 256;                // two warpgroups
constexpr int kRowBytes = 128;               // one swizzle row
constexpr int kBlock = kTile * kRowBytes;    // a 64-row block: 8 KiB

// byte offset of bf16 element (r, c) in a swizzled tile whose 64-column
// blocks lie block_bytes apart
__device__ __forceinline__ int off16(int block_bytes, int r, int c) {
  return (c >> 6) * block_bytes + r * kRowBytes +
         ((((c & 63) >> 3) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

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

// returns once the phase of parity `parity` has completed; a wait of 2^34
// clocks (seconds) means a lost phase and traps
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

// `bytes` contiguous bytes from global into shared memory, one bulk copy
// (the TMA's 1-D form, no tensor map), completing its bytes on the
// barrier; both addresses 16-byte aligned, bytes a multiple of 16
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// `bytes` contiguous bytes from shared memory back to global memory, one
// bulk copy in this thread's open bulk group; both addresses 16-byte
// aligned, bytes a multiple of 16. The writing threads' generic-proxy
// stores to the source must be fenced (fence_async) and synchronised
// before the copy is issued.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
          reinterpret_cast<uint64_t>(dst)),
      "r"(src), "r"(bytes)
      : "memory");
}
// closes this thread's open bulk group
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// returns once all but the newest N of this thread's bulk groups have
// read their shared-memory sources (which may then be reused or released)
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// one box of a 3-D tensor map (coordinates innermost first) into shared
// memory, completing its bytes on the barrier
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

// this thread's generic-proxy shared-memory writes, made visible to the
// async proxy (wgmma's operand reads, TMA's writes)
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: K-major operands step
// 8-row groups by sbo = 1024 bytes (lbo unused); MN-major ones are one
// 64-wide swizzle atom each, stepped along K by 8-row groups (1024 bytes)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
// k16 step kk of a K-major operand: 64 rows at `base`, 64-column blocks
// block_bytes apart
__device__ __forceinline__ uint64_t kdesc(uint32_t base, int block_bytes,
                                          int kk) {
  return desc(base + (kk >> 2) * block_bytes + (kk & 3) * 32, 16, 1024);
}
// k16 step kk of an MN-major operand: one 64-column block at `base`, K
// along its rows
__device__ __forceinline__ uint64_t mdesc(uint32_t base, int kk) {
  return desc(base + kk * 16 * kRowBytes, 1024, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving register reads and writes across the
// asynchronous window between a wgmma's issue and its wait
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N][32]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_regs(r[i]);
}

// d (64×64 fp32) += A (64×16) · B (16×64), both from shared memory; TA,
// TB: 0 K-major, 1 MN-major; scale_d = 0: d = A·B
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64×64 fp32) += A (64×16 bf16, registers) · B (16×64, shared,
// MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ float lo_f(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float hi_f(uint32_t x) {
  return __uint_as_float(x & 0xFFFF0000u);
}

// The bf16 copy of a warpgroup's state rows 64·wg + (0..63), all columns,
// into the copy's swizzled blocks (xblock bytes apart). x is the state in
// the accumulator layout (rows r0 and r0 + 8, columns 8g + cl + e).
template <int DC>
__device__ __forceinline__ void store_state(uint8_t* xs, int xblock,
                                            const float (&x)[DC][32], int wg,
                                            int r0, int cl) {
#pragma unroll
  for (int j = 0; j < DC; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int r = 64 * wg + r0 + 8 * h;
        *reinterpret_cast<uint32_t*>(xs + off16(xblock, r,
                                                64 * j + 8 * g + cl)) =
            pack_bf16(x[j][4 * g + 2 * h], x[j][4 * g + 2 * h + 1]);
      }
}

// A score tile in the accumulator layout (row r0 + 8h, column 8g + cl + e
// at register 4g + 2h + e), masked to column <= row (LOWER) or column >=
// row, as wgmma's A operand in bf16. k16 step kk holds columns
// 16kk..16kk+15, registers 8kk..8kk+7.
template <bool LOWER>
__device__ __forceinline__ void mask_pack(const float (&s)[32],
                                          uint32_t (&p)[4][4], int r0,
                                          int cl) {
#pragma unroll
  for (int x = 0; x < 32; x += 2) {
    const int r = r0 + 8 * ((x >> 1) & 1), c = 8 * (x >> 2) + cl;
    const float a = (LOWER ? c <= r : c >= r) ? s[x] : 0.f;
    const float b = (LOWER ? c + 1 <= r : c + 1 >= r) ? s[x + 1] : 0.f;
    p[x / 8][(x % 8) / 2] = pack_bf16(a, b);
  }
}

// mask_pack's tile in two bf16 parts, hi = bf16(s) and lo = bf16(s - hi),
// so that the scores are not rounded to 8 bits
template <bool LOWER>
__device__ __forceinline__ void mask_split(const float (&s)[32],
                                           uint32_t (&hi)[4][4],
                                           uint32_t (&lo)[4][4], int r0,
                                           int cl) {
#pragma unroll
  for (int x = 0; x < 32; x += 2) {
    const int r = r0 + 8 * ((x >> 1) & 1), c = 8 * (x >> 2) + cl;
    const float a = (LOWER ? c <= r : c >= r) ? s[x] : 0.f;
    const float b = (LOWER ? c + 1 <= r : c + 1 >= r) ? s[x + 1] : 0.f;
    const uint32_t h = pack_bf16(a, b);
    hi[x / 8][(x % 8) / 2] = h;
    lo[x / 8][(x % 8) / 2] = pack_bf16(a - lo_f(h), b - hi_f(h));
  }
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

// (d, n, rows) of bf16 (fp32 == 0) or fp32, rows of n·d contiguous; box
// (64 bf16 or 32 fp32 = 128 bytes, 64, 1), 128-byte swizzle, elements out
// of bounds read as zero
int tensor_map(CUtensorMap* map, const void* ptr, int fp32, int d, int n,
               int rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  // The driver call needs the device's context current on this thread. A
  // thread that has only reused cached allocations (autograd's backward
  // thread) may have none yet; cudaFree(nullptr) makes the runtime's
  // current, and frees nothing.
  static thread_local bool bound = false;
  if (!bound) {
    const cudaError_t err = cudaFree(nullptr);
    if (err != cudaSuccess) return static_cast<int>(err);
    bound = true;
  }
  const cuuint64_t es = fp32 ? 4 : 2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * es,
                                 static_cast<cuuint64_t>(n) * d * es};
  const cuuint32_t box[3] = {fp32 ? 32u : 64u, kTile, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = encode(
      map,
      fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  // CUDA_ERROR_INVALID_VALUE and the like, kept apart from runtime codes
  return res == CUDA_SUCCESS ? 0 : 10000 + static_cast<int>(res);
}

// the maps of N (d, n, rows) tensors: the first n_bf16 bf16, the rest fp32
template <int N>
int tensor_maps(CUtensorMap (&m)[N], const void* const (&ptrs)[N],
                int n_bf16, int d, int n, int rows) {
  for (int i = 0; i < N; ++i) {
    const int err = tensor_map(&m[i], ptrs[i], i >= n_bf16, d, n, rows);
    if (err) return err;
  }
  return 0;
}

// the kernel's opt-in to `smem` bytes of dynamic shared memory, once
template <typename Kernel>
int configure(Kernel kernel, int smem, bool& configured) {
  if (configured) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  configured = true;
  return 0;
}

// TMA takes 16-byte aligned tensors (a null pointer passes)
inline bool misaligned(const void* a, const void* b, const void* c,
                       const void* d = nullptr, const void* e = nullptr) {
  return (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
          reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d) |
          reinterpret_cast<uintptr_t>(e)) %
         16;
}

}  // namespace tc
}  // namespace
