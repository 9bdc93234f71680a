// Device helpers shared by flash_attention.cu and flash_attention_wide.cu:
// the mask's tile bounds, cp.async, ldmatrix, mma.sync on 16-bit types, the
// swizzled shared-memory tile layout, and the launch wrapper. Semantics are
// those of horovod_tpu/ops/pallas_attention.py (see flash_attention.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace hvd_flash {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // key rows per tile
constexpr int MT = 128;         // threads of a tensor-core block: 4 warps
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// dtype codes shared with ops/flash_attention.py.
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kF16 = 2;

// Key tiles of `bk` rows a query tile of `bq` rows starting at q_start
// must visit: all of them, or under the causal mask (decode convention:
// query row r sits at position r + Skv - Sq) those up to its last row.
__device__ __forceinline__ int key_tiles(int q_start, int Sq, int Skv,
                                         int causal, int bq = BQ,
                                         int bk = BK) {
  int n = (Skv + bk - 1) / bk;
  if (causal) {
    const int last = q_start + bq + (Skv - Sq);  // one past the last key
    const int need = last <= 0 ? 0 : (last + bk - 1) / bk;
    n = need < n ? need : n;
  }
  return n;
}

__device__ __forceinline__ bool visible(int qrow, int kcol, int Sq, int Skv,
                                        int causal) {
  return qrow < Sq && kcol < Skv && (!causal || kcol <= qrow + (Skv - Sq));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !ok (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4],
                                          const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a (16x16, row) * b (16x8, col), 16-bit T in (bf16 or fp16), fp32
// accumulate.
template <typename T>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma16<bf16>(float (&d)[4],
                                            const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16<f16>(float (&d)[4],
                                           const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to nearest into one register of two T.
template <typename T>
__device__ __forceinline__ uint32_t pack16(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack16<bf16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack16<f16>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Element offset of 16-byte chunk `chunk` of row `row` in a 64 x D tile of
// 16-bit values. A 128-byte line of shared memory holds 8 chunks, i.e. RPL
// rows; the chunk index is XORed with the line index, so any 8 consecutive
// rows at one logical chunk fall in 8 distinct chunk slots of a line.
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  constexpr int CPR = D / 8;
  constexpr int RPL = CPR >= 8 ? 1 : 8 / CPR;
  constexpr int MASK = (CPR >= 8 ? 8 : CPR) - 1;
  return row * D + ((chunk ^ ((row / RPL) & MASK)) << 3);
}

// Rows [row0, row0 + 64) of an (n_rows, D) panel into a swizzled tile by
// cp.async; rows past n_rows are zero.
template <int D, typename T>
__device__ __forceinline__ void cp_tile(T* dst, const T* src, int row0,
                                        int n_rows) {
  constexpr int CPR = D / 8;
#pragma unroll
  for (int i = 0; i < 64 * CPR / MT; ++i) {
    const int idx = threadIdx.x + i * MT;
    const int r = idx / CPR, c = idx % CPR;
    const int gr = row0 + r;
    const bool ok = gr < n_rows;
    cp_async16(dst + swz<D>(r, c), src + (size_t)(ok ? gr : 0) * D + c * 8,
               ok);
  }
}

// Lane -> (row, chunk) of the ldmatrix.x4 address for 16 rows x 2 chunks.
// A operand (and a .trans B operand): matrices (rows 0-7, chunk 0),
// (rows 8-15, chunk 0), (rows 0-7, chunk 1), (rows 8-15, chunk 1), which
// are a0..a3, or b0, b1 of n-tile 0 and b0, b1 of n-tile 1.
__device__ __forceinline__ int a_row(int lane) {
  return (lane & 7) + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int a_chunk(int lane) { return lane >> 4; }
// B operand stored n-major (rows are n, chunks are k): matrices
// (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15),
// which are b0, b1 of n-tile 0 and b0, b1 of n-tile 1.
__device__ __forceinline__ int b_row(int lane) {
  return (lane & 7) + (lane >> 4) * 8;
}
__device__ __forceinline__ int b_chunk(int lane) { return (lane >> 3) & 1; }

// Raise the kernel's dynamic shared memory limit, launch, and return the
// launch's error (a refused launch never runs, so it is caught here).
template <typename... P, typename... A>
cudaError_t launch(void (*kernel)(P...), dim3 grid, int threads, size_t smem,
                   cudaStream_t st, A... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(f16 x) { return __half2float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ f16 from_f32<f16>(float x) {
  return __float2half(x);
}

// Query rows that see no key: under the causal mask with Sq > Skv, rows
// r < Sq - Skv sit before the first key. Every forward route holds them to
// one convention, the reference's with one tile spanning the sequence
// (pallas_attention.py:94-111: every key visited, each score NEG_INF, each
// weighing exp(0) = 1): O is the mean of V over all Skv keys and lse is
// NEG_INF + log Skv in fp32. The forward kernels leave what their tiles
// give there; this kernel, launched after them only where such rows exist,
// writes the convention over it. A block sums 128 columns of one head's V
// in a fixed order.
template <typename T>
__global__ void __launch_bounds__(128)
    none_rows_kernel(const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Skv, int D) {
  const size_t bh = blockIdx.x;
  const int rows = Sq - Skv;
  if (blockIdx.y == 0)
    for (int r = threadIdx.x; r < rows; r += 128)
      lse[bh * Sq + r] = NEG_INF + logf((float)Skv);
  const int col = blockIdx.y * 128 + threadIdx.x;
  if (col >= D) return;
  const T* vp = v + bh * Skv * D + col;
  float sum = 0.f;
  for (int r = 0; r < Skv; ++r) sum += to_f32(vp[(size_t)r * D]);
  const T mean = from_f32<T>(sum / Skv);
  T* op = o + bh * Sq * D + col;
  for (int r = 0; r < rows; ++r) op[(size_t)r * D] = mean;
}

template <typename T>
cudaError_t launch_none_rows(const void* v, void* o, void* lse, int B, int H,
                             int Sq, int Skv, int D, int causal,
                             cudaStream_t st) {
  if (!causal || Sq <= Skv) return cudaSuccess;
  return launch(none_rows_kernel<T>, dim3(B * H, (D + 127) / 128), 128, 0,
                st, (const T*)v, (T*)o, (float*)lse, Sq, Skv, D);
}

}  // namespace hvd_flash
