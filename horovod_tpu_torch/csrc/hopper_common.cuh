// Hopper (sm_90a) pieces shared by the flash kernels built on wgmma and
// TMA: fwd_wgmma_kernel (hopper_fwd.cuh, head dims 16-256), and
// wide_fwd_wgmma_kernel (head dims 320-576), wide_dkv_wgmma_kernel and
// wide_dq_wgmma_kernel (192-576) in flash_attention_wide.cu. The mbarrier
// waits, the TMA load and the tensor map of a panel, the wgmma
// shared-memory descriptor, the wgmma wrappers for every N the kernels
// issue, the heads' grouping of the wide kernels, and ex2.
#pragma once

#include "flash_common.cuh"

#include <cuda.h>  // CUtensorMap and its enums; nothing links libcuda

#include <type_traits>

namespace hvd_flash {

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(b)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(b))
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint64_t* b, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(b)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t ns;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(ns));
  return ns;
}

// Until the phase of parity `parity` has completed. A wait that outlasts
// 10 s traps: a broken pipeline fails the launch instead of hanging the
// card.
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  if (mbar_try(b, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try(b, parity))
    if (global_ns() - t0 > 10000000000ull) __trap();
}

// Where the bounded wait below records that it gave up: g_stalled, in
// device memory, which every later bounded wait reads before it spins, so
// that a broken launch ends about 10 s after its first stall rather than
// 10 s a wait; and *g_stall_word, a word of mapped host memory that the
// host reads without a copy (flash_attention_wide.cu, arm_stall_word): once
// it is set, every later call of the library fails, as every later call
// of the context fails after a trap.
__device__ unsigned g_stalled;
__device__ unsigned* g_stall_word;

// The same wait without the trap: after 10 s it gives up and records it
// (above), so a broken pipeline fails the library's next call instead of
// hanging the card. A trap anywhere in a setmaxnreg branch holds that
// branch to the registers the block starts with (168 for 384 threads),
// whatever setmaxnreg.inc asks; this record does not
// (tools/setmaxnreg_probe.py).
__device__ __forceinline__ void mbar_wait_bounded(uint64_t* b, int parity) {
  if (mbar_try(b, parity)) return;
  if (*reinterpret_cast<volatile unsigned*>(&g_stalled)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try(b, parity))
    if (global_ns() - t0 > 10000000000ull) {
      *reinterpret_cast<volatile unsigned*>(&g_stalled) = 1;
      if (g_stall_word)
        *reinterpret_cast<volatile unsigned*>(g_stall_word) = 1;
      __threadfence_system();
      return;
    }
}

// One box of a 3-D tensor map at (column, row, head) into shared memory,
// completing its bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle (128, 64 or 32 bytes).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int sw) {
  const uint64_t layout = sw == 128 ? 1 : sw == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The compiler sees a wgmma's accumulators written when it is issued;
// pinning them after a wait keeps every read of them after the wait.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// S (64 x N, fp32) = A (64 x 16, shared) * B (N x 16, shared)^T, both
// K-major; d[4 i + e] holds row g + 8 (e >> 1), column 8 i + 2 t + (e & 1)
// of the thread's warp's 16 rows.
template <int N, typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d);
// O (64 x N) += A (64 x 16, shared, K-major) * B (16 x N, shared,
// MN-major): P from shared memory times V.
template <int N, typename T>
__device__ __forceinline__ void wgmma_ss_t(float (&d)[N / 2], uint64_t a,
                                           uint64_t b, int scale_d);
// O (64 x N) += P (64 x 16, registers, the mma.sync A layout) * B (16 x N,
// shared, MN-major).
template <int N, typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d);

// The specialisations differ only in N, the PTX type and B's transpose
// bit. A thread holds N / 2 accumulators, operands %0 .. %(N / 2 - 1)
// (HVD_ACC<N>, named in the instruction by HVD_REGS<N>); the operands after
// them are numbered from N / 2 on, and each instantiation below names their
// numbers.
#define HVD_A4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define HVD_ACC16(i) HVD_A4(i), HVD_A4(i + 4)
#define HVD_ACC24(i) HVD_ACC16(i), HVD_A4(i + 8)
#define HVD_ACC32(i) HVD_ACC16(i), HVD_ACC16(i + 8)
#define HVD_ACC48(i) HVD_ACC32(i), HVD_ACC16(i + 16)
#define HVD_ACC64(i) HVD_ACC32(i), HVD_ACC32(i + 16)
#define HVD_ACC80(i) HVD_ACC64(i), HVD_ACC16(i + 32)
#define HVD_ACC96(i) HVD_ACC64(i), HVD_ACC32(i + 32)
#define HVD_ACC128(i) HVD_ACC64(i), HVD_ACC64(i + 32)
#define HVD_ACC160(i) HVD_ACC128(i), HVD_ACC32(i + 64)
#define HVD_ACC192(i) HVD_ACC128(i), HVD_ACC64(i + 64)
#define HVD_ACC224(i) HVD_ACC192(i), HVD_ACC32(i + 96)
#define HVD_ACC256(i) HVD_ACC128(i), HVD_ACC128(i + 64)
#define HVD_REGS16 "%0, %1, %2, %3, %4, %5, %6, %7"
#define HVD_REGS24 HVD_REGS16 ", %8, %9, %10, %11"
#define HVD_REGS32 HVD_REGS24 ", %12, %13, %14, %15"
#define HVD_REGS48 HVD_REGS32 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define HVD_REGS64 \
  HVD_REGS32 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, " \
             "%27, %28, %29, %30, %31"
#define HVD_REGS80 \
  HVD_REGS64 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define HVD_REGS96 HVD_REGS80 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define HVD_REGS128 \
  HVD_REGS96 \
  ", %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59" \
  ", %60, %61, %62, %63"
#define HVD_REGS160 \
  HVD_REGS128 \
  ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75" \
  ", %76, %77, %78, %79"
#define HVD_REGS192 \
  HVD_REGS160 \
  ", %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91" \
  ", %92, %93, %94, %95"
#define HVD_REGS224 \
  HVD_REGS192 \
  ", %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106" \
  ", %107, %108, %109, %110, %111"
#define HVD_REGS256 \
  HVD_REGS224 \
  ", %112, %113, %114, %115, %116, %117, %118, %119, %120, %121" \
  ", %122, %123, %124, %125, %126, %127"

// wgmma_ss<N, T> (TB 0) and wgmma_ss_t<N, T> (TB 1, B MN-major): A and B
// descriptors at %A and %B, scale_d at %S.
#define HVD_WGMMA_DESC(FN, TB, N, T, PTX, A, B, S)                        \
  template <>                                                             \
  __device__ __forceinline__ void FN<N, T>(                               \
      float(&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {            \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #S ", 0;\n"         \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." PTX    \
                 "." PTX " {" HVD_REGS##N "}, %" #A ", %" #B              \
                 ", p, 1, 1, 0, " #TB ";\n}\n"                            \
                 : HVD_ACC##N(0)                                          \
                 : "l"(a), "l"(b), "r"(scale_d));                         \
  }
#define HVD_WGMMA_SS(N, T, PTX, A, B, S) \
  HVD_WGMMA_DESC(wgmma_ss, 0, N, T, PTX, A, B, S)
#define HVD_WGMMA_SST(N, T, PTX, A, B, S) \
  HVD_WGMMA_DESC(wgmma_ss_t, 1, N, T, PTX, A, B, S)
// wgmma_rs<N, T>: A's four registers at %A0 .. %A0 + 3 (listed), the B
// descriptor at %B, scale_d at %S; B transposed (MN-major).
#define HVD_WGMMA_RS(N, T, PTX, A0, A1, A2, A3, B, S)                     \
  template <>                                                             \
  __device__ __forceinline__ void wgmma_rs<N, T>(                         \
      float(&d)[N / 2], const uint32_t(&a)[4], uint64_t b, int scale_d) { \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #S ", 0;\n"         \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." PTX    \
                 "." PTX " {" HVD_REGS##N "}, {%" #A0 ", %" #A1 ", %" #A2 \
                 ", %" #A3 "}, %" #B ", p, 1, 1, 1;\n}\n"                 \
                 : HVD_ACC##N(0)                                          \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),    \
                   "r"(scale_d));                                         \
  }

// Scores: fwd_wgmma_kernel's tiles of 64 to 128 keys (80 and 96 for
// tools/flash_fwd_variants.py), the wide forward's key slices (16 to 32
// keys a warpgroup), and the wide backward's tiles (16 to 64 keys or
// query rows, flash_attention_wide.cu).
HVD_WGMMA_SS(16, bf16, "bf16", 8, 9, 10)
HVD_WGMMA_SS(24, bf16, "bf16", 12, 13, 14)
HVD_WGMMA_SS(32, bf16, "bf16", 16, 17, 18)
HVD_WGMMA_SS(48, bf16, "bf16", 24, 25, 26)
HVD_WGMMA_SS(64, bf16, "bf16", 32, 33, 34)
HVD_WGMMA_SS(80, bf16, "bf16", 40, 41, 42)
HVD_WGMMA_SS(96, bf16, "bf16", 48, 49, 50)
HVD_WGMMA_SS(128, bf16, "bf16", 64, 65, 66)
HVD_WGMMA_SS(16, f16, "f16", 8, 9, 10)
HVD_WGMMA_SS(24, f16, "f16", 12, 13, 14)
HVD_WGMMA_SS(32, f16, "f16", 16, 17, 18)
HVD_WGMMA_SS(48, f16, "f16", 24, 25, 26)
HVD_WGMMA_SS(64, f16, "f16", 32, 33, 34)
HVD_WGMMA_SS(80, f16, "f16", 40, 41, 42)
HVD_WGMMA_SS(96, f16, "f16", 48, 49, 50)
HVD_WGMMA_SS(128, f16, "f16", 64, 65, 66)
// From shared memory, B MN-major: P V, the wide forward's column slices of
// O; dS K, the wide dQ's column halves; P^T dO and dS^T Q, the wide dK/dV's
// column parts.
HVD_WGMMA_SST(128, bf16, "bf16", 64, 65, 66)
HVD_WGMMA_SST(160, bf16, "bf16", 80, 81, 82)
HVD_WGMMA_SST(192, bf16, "bf16", 96, 97, 98)
HVD_WGMMA_SST(224, bf16, "bf16", 112, 113, 114)
HVD_WGMMA_SST(256, bf16, "bf16", 128, 129, 130)
HVD_WGMMA_SST(128, f16, "f16", 64, 65, 66)
HVD_WGMMA_SST(160, f16, "f16", 80, 81, 82)
HVD_WGMMA_SST(192, f16, "f16", 96, 97, 98)
HVD_WGMMA_SST(224, f16, "f16", 112, 113, 114)
HVD_WGMMA_SST(256, f16, "f16", 128, 129, 130)
// P V from registers: fwd_wgmma_kernel at head dims 16-128.
HVD_WGMMA_RS(16, bf16, "bf16", 8, 9, 10, 11, 12, 13)
HVD_WGMMA_RS(32, bf16, "bf16", 16, 17, 18, 19, 20, 21)
HVD_WGMMA_RS(64, bf16, "bf16", 32, 33, 34, 35, 36, 37)
HVD_WGMMA_RS(128, bf16, "bf16", 64, 65, 66, 67, 68, 69)
HVD_WGMMA_RS(192, bf16, "bf16", 96, 97, 98, 99, 100, 101)
HVD_WGMMA_RS(256, bf16, "bf16", 128, 129, 130, 131, 132, 133)
HVD_WGMMA_RS(16, f16, "f16", 8, 9, 10, 11, 12, 13)
HVD_WGMMA_RS(32, f16, "f16", 16, 17, 18, 19, 20, 21)
HVD_WGMMA_RS(64, f16, "f16", 32, 33, 34, 35, 36, 37)
HVD_WGMMA_RS(128, f16, "f16", 64, 65, 66, 67, 68, 69)
HVD_WGMMA_RS(192, f16, "f16", 96, 97, 98, 99, 100, 101)
HVD_WGMMA_RS(256, f16, "f16", 128, 129, 130, 131, 132, 133)
#undef HVD_WGMMA_DESC
#undef HVD_WGMMA_SS
#undef HVD_WGMMA_SST
#undef HVD_WGMMA_RS
#undef HVD_A4
#undef HVD_ACC16
#undef HVD_ACC24
#undef HVD_ACC32
#undef HVD_ACC48
#undef HVD_ACC64
#undef HVD_ACC80
#undef HVD_ACC96
#undef HVD_ACC128
#undef HVD_ACC160
#undef HVD_ACC192
#undef HVD_ACC224
#undef HVD_ACC256
#undef HVD_REGS16
#undef HVD_REGS24
#undef HVD_REGS32
#undef HVD_REGS48
#undef HVD_REGS64
#undef HVD_REGS80
#undef HVD_REGS96
#undef HVD_REGS128
#undef HVD_REGS160
#undef HVD_REGS192
#undef HVD_REGS224
#undef HVD_REGS256

// The (head, query tile) of this block of a 1-D grid of B * H * nqt. Blocks
// walk the heads in groups whose K and V (16-bit, Skv x D each) take at
// most L2_GROUP_BYTES together, so the query tiles of a group's heads read
// K and V from L2, not from device memory, once the first has; within a
// group the query tiles go last to first (under the causal mask the last
// has the most keys) across its heads, so the longest tiles start first.
// A quarter of the H100's 50 MB of L2: tools/flash_fwd_variants.py --wide
// times 8 and 64 MB and no grouping beside it.
constexpr long long L2_GROUP_BYTES = 16ll << 20;

__device__ __forceinline__ void grouped_tile(int nqt, int Skv, int D,
                                             int& bh, int& qt) {
  const int heads = gridDim.x / nqt;
  long long g = L2_GROUP_BYTES / (4ll * Skv * D);
  const int group = g < 1 ? 1 : g > heads ? heads : (int)g;
  const int first = blockIdx.x / (group * nqt) * group;
  const int n = heads - first < group ? heads - first : group;
  const int idx = blockIdx.x - first * nqt;
  qt = nqt - 1 - idx / n;
  bh = first + idx % n;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// cuTensorMapEncodeTiled, reached through the runtime so that nothing
// links against libcuda; null when the installed libcuda lacks it.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The 3-D map (D, rows, B * H) of a contiguous (B, H, rows, D) panel of
// 16-bit T, in boxes of (box_cols, box_rows, 1) with a swizzle of `sw`
// bytes (a box row's bytes); rows past each head's last are zero-filled.
template <typename T>
bool tensor_map(CUtensorMap* map, const void* ptr, int D, int rows, int BH,
                int box_cols, int box_rows, int sw) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swz = sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : sw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUtensorMapDataType type = std::is_same<T, bf16>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hvd_flash
