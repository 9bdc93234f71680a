// Flash attention for Hopper (sm_90a): forward, dK/dV and dQ kernels.
//
// Built by horovod_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through the plain C entry points at the bottom of this file
// (ctypes). Every tensor is a contiguous (B, H, S, D) panel; lse and delta
// are contiguous (B, H, Sq) fp32. Inputs are fp32 or bf16, every product
// and sum is fp32, outputs take the inputs' type (lse stays fp32).
//
// Semantics are those of horovod_tpu/ops/pallas_attention.py: q is scaled
// once at load, the causal mask uses the decode convention (query row r
// has absolute position r + Skv - Sq), masked scores are NEG_INF = -1e30
// (not -inf, so a fully masked key block behaves as in the TPU kernel),
// key columns >= Skv are masked, and a row with l == 0 divides by 1.
//
// Design, shared by the three kernels (the TPU blocking is not carried
// over). The TPU kernels keep the whole per-(b, h) K/V panel resident in
// VMEM and use 256/512 tiles; a Hopper block has at most 227 KB of shared
// memory, so here one thread block owns one 64-row tile of the output and
// streams the other operand through shared memory in 64-row tiles; the
// sequential TPU grid axis becomes the loop inside the block. 256 threads
// form a 16x16 grid: a thread owns rows {ty + 16 i} and columns
// {tx + 16 j} of every 64x64 score tile, so a row's 64 scores live in 16
// lanes of one warp and the row reductions of the online softmax are four
// xor-shuffles. Shared tiles are stored as fp32 with a row stride of D + 1
// words, which keeps the column walks free of bank conflicts. Ragged S and
// padding are masked in the kernel (no padded copies). The backward keeps
// the reference's split into a dK/dV kernel (one key tile, streams query
// tiles) and a dQ kernel (one query tile, streams key tiles): each output
// element is written by one block, with no atomics, so it is
// deterministic. The products are fp32 FMA loops out of shared memory;
// mma.sync / wgmma with TMA is later work (PERF.md holds the times).
//
// Bounds at the flagship's long-context shape (B=4, H=8, S=2048, D=64,
// bf16, causal: S(S+1)/2 = 2,098,176 unmasked (q, k) pairs per head), at
// the H100 SXM's 989 TFLOP/s bf16 and 3.35 TB/s:
//   forward: 2 products, 4 * 32 * 2,098,176 * 64 = 17.2 GFLOP -> 17.4 us;
//            q, k, v read + o written (bf16) + lse (fp32) = 33.8 MB -> 10.1 us.
//   dK/dV:   4 products, 34.4 GFLOP -> 34.7 us; 50.9 MB -> 15.2 us.
//   dQ:      3 products, 25.8 GFLOP -> 26.1 us; 42.5 MB -> 12.7 us.
// All three are bound by operations. This first version runs the products
// on the fp32 FMA pipes (67 TFLOP/s at best), so it cannot come near the
// bound; what the design secures is that no score matrix ever reaches
// device memory and that each input byte is read once per tile pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // key rows per tile
constexpr int TX = 16;          // thread grid: 16 x 16
constexpr int TY = 16;
constexpr int NT = TX * TY;     // 256 threads per block
constexpr int RI = BQ / TY;     // rows of a score tile per thread
constexpr int CJ = BK / TX;     // columns of a score tile per thread
constexpr int LP = 65;          // row stride of a 64x64 score tile in smem
constexpr float NEG_INF = -1e30f;

static_assert(BQ == BK, "tile loads assume square score tiles");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// Rows [row0, row0 + 64) of an (n_rows, D) panel into smem (stride D + 1),
// times mul; rows past n_rows are zero.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int n_rows, float mul) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int gr = row0 + r;
    dst[r * (D + 1) + c] =
        gr < n_rows ? to_f(src[(size_t)gr * D + c]) * mul : 0.f;
  }
}

// lse and delta of query rows [row0, row0 + 64); rows past Sq get
// lse = +inf and delta = 0, so they contribute nothing.
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const float* lse,
                                          const float* delta, int row0,
                                          int Sq) {
  for (int r = threadIdx.x; r < BQ; r += NT) {
    const int gr = row0 + r;
    lse_s[r] = gr < Sq ? lse[gr] : INFINITY;
    delta_s[r] = gr < Sq ? delta[gr] : 0.f;
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Key tiles a query tile starting at q_start must visit.
__device__ __forceinline__ int key_tiles(int q_start, int Sq, int Skv,
                                         int causal) {
  int n = (Skv + BK - 1) / BK;
  if (causal) {
    const int last = q_start + BQ + (Skv - Sq);  // one past the last key
    const int need = last <= 0 ? 0 : (last + BK - 1) / BK;
    n = need < n ? need : n;
  }
  return n;
}

__device__ __forceinline__ bool visible(int qrow, int kcol, int Sq, int Skv,
                                        int causal) {
  return qrow < Sq && kcol < Skv && (!causal || kcol <= qrow + (Skv - Sq));
}

// ------------------------------------------------------------- forward ---
// Replaces _fwd_kernel (horovod_tpu/ops/pallas_attention.py:55).
// Grid (ceil(Sq/64), H, B): one 64-row query tile per block, a running
// (m, l, acc) per row in registers, key/value tiles streamed up to the
// causal bound.
template <int D, typename T>
__global__ void __launch_bounds__(NT)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               float* __restrict__ lse, int H, int Sq, int Skv, int causal,
               float scale) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / TX;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;  // BQ x LP

  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const T* qp = q + bh * Sq * D;
  const T* kp = k + bh * Skv * D;
  const T* vp = v + bh * Skv * D;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int q_start = blockIdx.x * BQ;

  load_tile<D>(Qs, qp, q_start, Sq, scale);

  float acc[RI][DJ];
  float m[RI], l[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int nkb = key_tiles(q_start, Sq, Skv, causal);
  for (int kb = 0; kb < nkb; ++kb) {
    __syncthreads();  // the previous tile's Ks/Vs/Ps are no longer read
    load_tile<D>(Ks, kp, kb * BK, Skv, 1.f);
    load_tile<D>(Vs, vp, kb * BK, Skv, 1.f);
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = Qs[(ty + TY * i) * LD + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = Ks[(tx + TX * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qrow = q_start + ty + TY * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kcol = kb * BK + tx + TX * j;
        // Padded query rows (qrow >= Sq) are never written; the mask
        // here is the reference's: key columns and the causal bound.
        const bool ok =
            kcol < Skv && (!causal || kcol <= qrow + (Skv - Sq));
        if (!ok) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max16(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + TY * i) * LP + tx + TX * j] = p;
        rs += p;
      }
      rs = row_sum16(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      float pv[RI], vv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = Ps[(ty + TY * i) * LP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * LD + tx + TX * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* op = o + bh * Sq * D;
  float* lp = lse + bh * Sq;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qrow = q_start + ty + TY * i;
    if (qrow >= Sq) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];
    const float inv = 1.f / ls;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      op[(size_t)qrow * D + tx + TX * j] = from_f<T>(acc[i][j] * inv);
    if (tx == 0) lp[qrow] = m[i] + logf(ls);
  }
}

// --------------------------------------------------------- backward dK/dV ---
// Replaces _bwd_dkv_kernel (horovod_tpu/ops/pallas_attention.py:114).
// Grid (ceil(Skv/64), H, B): one 64-row key tile per block, query tiles
// streamed from the first one that can see it. A thread owns key rows
// {ty + 16 i}; the score tile is held transposed (key x query).
template <int D, typename T>
__global__ void __launch_bounds__(NT)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk,
               T* __restrict__ dv, int H, int Sq, int Skv, int causal,
               float scale) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / TX;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;   // BK x LP, key-major
  float* dSs = Ps + BK * LP;   // BK x LP, key-major
  float* lse_s = dSs + BK * LP;
  float* delta_s = lse_s + BQ;

  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const T* qp = q + bh * Sq * D;
  const T* dop = dout + bh * Sq * D;
  const T* kp = k + bh * Skv * D;
  const T* vp = v + bh * Skv * D;
  const float* lsep = lse + bh * Sq;
  const float* deltap = delta + bh * Sq;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int k_start = blockIdx.x * BK;

  load_tile<D>(Ks, kp, k_start, Skv, 1.f);
  load_tile<D>(Vs, vp, k_start, Skv, 1.f);

  float dK[RI][DJ], dV[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dK[i][j] = dV[i][j] = 0.f;

  const int nqb = (Sq + BQ - 1) / BQ;
  int qb0 = 0;
  if (causal) {
    // Query rows r with r + (Skv - Sq) >= k_start see this key tile.
    const int first = k_start - (Skv - Sq);
    qb0 = (first > 0 ? first : 0) / BQ;
  }
  for (int qb = qb0; qb < nqb; ++qb) {
    const int q_start = qb * BQ;
    __syncthreads();
    load_tile<D>(Qs, qp, q_start, Sq, scale);
    load_tile<D>(dOs, dop, q_start, Sq, 1.f);
    load_rows(lse_s, delta_s, lsep, deltap, q_start, Sq);
    __syncthreads();

    float s[RI][CJ], dp[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[RI], vv[RI], qv[CJ], ov[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        kv[i] = Ks[(ty + TY * i) * LD + d];
        vv[i] = Vs[(ty + TY * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        qv[j] = Qs[(tx + TX * j) * LD + d];
        ov[j] = dOs[(tx + TX * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int kcol = k_start + ty + TY * i;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = tx + TX * j;
        const float p = visible(q_start + c, kcol, Sq, Skv, causal)
                            ? expf(s[i][j] - lse_s[c])
                            : 0.f;
        Ps[(ty + TY * i) * LP + c] = p;
        dSs[(ty + TY * i) * LP + c] = p * (dp[i][j] - delta_s[c]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BQ; ++c) {
      float pv[RI], sv[RI], ov[DJ], qv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        pv[i] = Ps[(ty + TY * i) * LP + c];
        sv[i] = dSs[(ty + TY * i) * LP + c];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        ov[j] = dOs[c * LD + tx + TX * j];
        qv[j] = Qs[c * LD + tx + TX * j];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dV[i][j] = fmaf(pv[i], ov[j], dV[i][j]);
          // q was scaled at load, so this is already dL/dk.
          dK[i][j] = fmaf(sv[i], qv[j], dK[i][j]);
        }
    }
  }

  T* dkp = dk + bh * Skv * D;
  T* dvp = dv + bh * Skv * D;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int kcol = k_start + ty + TY * i;
    if (kcol >= Skv) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dkp[(size_t)kcol * D + tx + TX * j] = from_f<T>(dK[i][j]);
      dvp[(size_t)kcol * D + tx + TX * j] = from_f<T>(dV[i][j]);
    }
  }
}

// ------------------------------------------------------------ backward dQ ---
// Replaces _bwd_dq_kernel (horovod_tpu/ops/pallas_attention.py:174).
// Grid (ceil(Sq/64), H, B): one 64-row query tile per block, key tiles
// streamed up to the causal bound, dQ scaled once at the end.
template <int D, typename T>
__global__ void __launch_bounds__(NT)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dq, int H,
              int Sq, int Skv, int causal, float scale) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / TX;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* dSs = Vs + BK * LD;  // BQ x LP
  float* lse_s = dSs + BQ * LP;
  float* delta_s = lse_s + BQ;

  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const T* qp = q + bh * Sq * D;
  const T* dop = dout + bh * Sq * D;
  const T* kp = k + bh * Skv * D;
  const T* vp = v + bh * Skv * D;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int q_start = blockIdx.x * BQ;

  load_tile<D>(Qs, qp, q_start, Sq, scale);
  load_tile<D>(dOs, dop, q_start, Sq, 1.f);
  load_rows(lse_s, delta_s, lse + bh * Sq, delta + bh * Sq, q_start, Sq);

  float dQ[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dQ[i][j] = 0.f;

  const int nkb = key_tiles(q_start, Sq, Skv, causal);
  for (int kb = 0; kb < nkb; ++kb) {
    __syncthreads();
    load_tile<D>(Ks, kp, kb * BK, Skv, 1.f);
    load_tile<D>(Vs, vp, kb * BK, Skv, 1.f);
    __syncthreads();

    float s[RI][CJ], dp[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RI], ov[RI], kv[CJ], vv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        qv[i] = Qs[(ty + TY * i) * LD + d];
        ov[i] = dOs[(ty + TY * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        kv[j] = Ks[(tx + TX * j) * LD + d];
        vv[j] = Vs[(tx + TX * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + TY * i;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kcol = kb * BK + tx + TX * j;
        const float p = visible(q_start + r, kcol, Sq, Skv, causal)
                            ? expf(s[i][j] - lse_s[r])
                            : 0.f;
        dSs[r * LP + tx + TX * j] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      float sv[RI], kv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) sv[i] = dSs[(ty + TY * i) * LP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = Ks[c * LD + tx + TX * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) dQ[i][j] = fmaf(sv[i], kv[j], dQ[i][j]);
    }
  }

  T* dqp = dq + bh * Sq * D;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qrow = q_start + ty + TY * i;
    if (qrow >= Sq) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dqp[(size_t)qrow * D + tx + TX * j] = from_f<T>(dQ[i][j] * scale);
  }
}

// ------------------------------------------------------------- launchers ---

template <int D> constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * 64 * (D + 1) + BQ * LP);
}
template <int D> constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * BK * LP + 2 * BQ);
}
template <int D> constexpr size_t dq_smem() {
  return sizeof(float) * (4 * 64 * (D + 1) + BQ * LP + 2 * BQ);
}

template <int D, typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int Sq, int Skv, int causal,
                       float scale, cudaStream_t st) {
  constexpr size_t smem = fwd_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(
      fwd_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fwd_kernel<D, T><<<grid, NT, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, H, Sq, Skv,
      causal, scale);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int H, int Sq, int Skv,
                       int causal, float scale, cudaStream_t st) {
  constexpr size_t smem = dkv_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(
      dkv_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Skv + BK - 1) / BK, H, B);
  dkv_kernel<D, T><<<grid, NT, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, H, Sq, Skv,
      causal, scale);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int H, int Sq, int Skv, int causal,
                      float scale, cudaStream_t st) {
  constexpr size_t smem = dq_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(
      dq_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  dq_kernel<D, T><<<grid, NT, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq, H, Sq, Skv, causal,
      scale);
  return cudaGetLastError();
}

// dtype codes shared with ops/flash_attention.py.
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

}  // namespace

// Dispatch on (head_dim, dtype); an unsupported pair is
// cudaErrorInvalidValue, which the Python wrapper raises on.
#define HVD_DISPATCH(D_, DT_, CALL)                                  \
  do {                                                               \
    switch (D_) {                                                    \
      case 16:                                                       \
        if (DT_ == kF32) return (int)CALL(16, float);                \
        if (DT_ == kBF16) return (int)CALL(16, __nv_bfloat16);       \
        break;                                                       \
      case 32:                                                       \
        if (DT_ == kF32) return (int)CALL(32, float);                \
        if (DT_ == kBF16) return (int)CALL(32, __nv_bfloat16);       \
        break;                                                       \
      case 64:                                                       \
        if (DT_ == kF32) return (int)CALL(64, float);                \
        if (DT_ == kBF16) return (int)CALL(64, __nv_bfloat16);       \
        break;                                                       \
      case 128:                                                      \
        if (DT_ == kF32) return (int)CALL(128, float);               \
        if (DT_ == kBF16) return (int)CALL(128, __nv_bfloat16);      \
        break;                                                       \
    }                                                                \
    return (int)cudaErrorInvalidValue;                               \
  } while (0)

extern "C" {

const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int hvd_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int B, int H, int Sq, int Skv, int D, int dtype,
                  int causal, float scale, void* stream) {
#define CALL(DD, TT) \
  launch_fwd<DD, TT>(q, k, v, o, lse, B, H, Sq, Skv, causal, scale, \
                     (cudaStream_t)stream)
  HVD_DISPATCH(D, dtype, CALL);
#undef CALL
}

int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int B, int H, int Sq, int Skv,
                      int D, int dtype, int causal, float scale,
                      void* stream) {
#define CALL(DD, TT)                                                     \
  launch_dkv<DD, TT>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Skv, \
                     causal, scale, (cudaStream_t)stream)
  HVD_DISPATCH(D, dtype, CALL);
#undef CALL
}

int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int B, int H, int Sq, int Skv, int D,
                     int dtype, int causal, float scale, void* stream) {
#define CALL(DD, TT)                                                    \
  launch_dq<DD, TT>(q, k, v, dout, lse, delta, dq, B, H, Sq, Skv, causal, \
                    scale, (cudaStream_t)stream)
  HVD_DISPATCH(D, dtype, CALL);
#undef CALL
}

}  // extern "C"
