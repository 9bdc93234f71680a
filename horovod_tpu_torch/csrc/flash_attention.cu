// Flash attention for Hopper (sm_90a): forward, dK/dV and dQ kernels.
//
// Built by horovod_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through the plain C entry points at the bottom of this file
// (ctypes). Every kernel lives in this one file, so the build's hash of it
// covers every source. Every tensor is a contiguous (B, H, S, D) panel;
// lse and delta are contiguous (B, H, Sq) fp32. Inputs are fp32 or bf16,
// every sum is fp32, outputs take the inputs' type (lse stays fp32).
//
// Semantics are those of horovod_tpu/ops/pallas_attention.py: the causal
// mask uses the decode convention (query row r has absolute position
// r + Skv - Sq), masked scores are NEG_INF = -1e30 (not -inf, so a fully
// masked key block behaves as in the TPU kernel), key columns >= Skv are
// masked, and a row with l == 0 divides by 1.
//
// Two designs. bf16 inputs run on the tensor cores (the "tensor-core
// path" section below: fwd_mma_kernel, dkv_mma_kernel, dq_mma_kernel).
// fp32 inputs run on the fp32 FMA kernels that follow here: on the tensor
// cores fp32 would mean TF32, about three decimal digits, which the fp32
// checks (1e-4) do not allow.
//
// FMA design, shared by its three kernels (q is scaled once at load; the
// TPU blocking is not carried over). The TPU kernels keep the whole
// per-(b, h) K/V panel resident in VMEM and use 256/512 tiles; a Hopper
// block has at most 227 KB of shared
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
// deterministic. The products are fp32 FMA loops out of shared memory
// (PERF.md holds the times).
//
// Bounds at the flagship's long-context shape (B=4, H=8, S=2048, D=64,
// bf16, causal: S(S+1)/2 = 2,098,176 unmasked (q, k) pairs per head), at
// the H100 SXM's 989 TFLOP/s bf16 and 3.35 TB/s:
//   forward: 2 products, 4 * 32 * 2,098,176 * 64 = 17.2 GFLOP -> 17.4 us;
//            q, k, v read + o written (bf16) + lse (fp32) = 33.8 MB -> 10.1 us.
//   dK/dV:   4 products, 34.4 GFLOP -> 34.7 us; 50.9 MB -> 15.2 us.
//   dQ:      3 products, 25.8 GFLOP -> 26.1 us; 42.5 MB -> 12.7 us.
// All three are bound by operations. The FMA kernels run the products on
// the fp32 FMA pipes (67 TFLOP/s at best), so they cannot come near the
// bound; what the design secures is that no score matrix ever reaches
// device memory and that each input byte is read once per tile pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

// =================================================== tensor-core path ===
// bf16 forward, dK/dV and dQ. They replace the same TPU kernels as
// fwd_kernel, dkv_kernel and dq_kernel and compute the same function;
// what bounds them is the same (operations, see above), and what this
// design does about it is to put every product on the tensor cores:
//  - products are mma.sync m16n8k16 bf16 x bf16 -> fp32; fragments come
//    from shared memory through ldmatrix (.trans where the operand is read
//    along its columns: V in P.V, dO in P^T.dO, Q in dS^T.Q, K in dS.K);
//  - operands stay bf16 in shared memory, in rows of 16-byte chunks whose
//    index is XOR-swizzled with the row (swz below), so the 8 row
//    addresses of every ldmatrix and the cp.async writes hit 8 distinct
//    16-byte bank groups;
//  - the streamed tiles arrive by cp.async (16 bytes a thread) in a
//    two-stage ring: tile t + 1 is in flight while tile t is multiplied;
//  - the m16n8 accumulator layout is the m16k16 A-operand layout, so P and
//    dS go from fp32 accumulators to bf16 A fragments in registers and
//    never touch shared memory;
//  - the scale is applied to the fp32 scores after the product and to dK
//    and dQ in their fp32 epilogues (bf16 q is never pre-scaled: D^-0.5
//    is not a power of two at D = 32 or 128, so that would add a
//    rounding);
//  - only tiles that the causal diagonal or a ragged edge cuts are masked;
//  - the tile index is the slowest grid dimension, ordered so that the
//    tiles with the most work under the causal mask start first.
// A block is 4 warps; each owns 16 rows of the block's 64-row tile. Each
// output element is written by one block, with no atomics.

using bf16 = __nv_bfloat16;
constexpr int MT = 128;  // threads of a tensor-core block: 4 warps
constexpr float LOG2E = 1.4426950408889634f;

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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Element offset of 16-byte chunk `chunk` of row `row` in a 64 x D bf16
// tile. A 128-byte line of shared memory holds 8 chunks, i.e. RPL rows;
// the chunk index is XORed with the line index, so any 8 consecutive rows
// at one logical chunk fall in 8 distinct chunk slots of a line.
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  constexpr int CPR = D / 8;
  constexpr int RPL = CPR >= 8 ? 1 : 8 / CPR;
  constexpr int MASK = (CPR >= 8 ? 8 : CPR) - 1;
  return row * D + ((chunk ^ ((row / RPL) & MASK)) << 3);
}

// Rows [row0, row0 + 64) of an (n_rows, D) panel into a swizzled tile by
// cp.async; rows past n_rows are zero.
template <int D>
__device__ __forceinline__ void cp_tile(bf16* dst, const bf16* src, int row0,
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

// ------------------------------------------------ tensor-core forward ---
// Replaces _fwd_kernel (horovod_tpu/ops/pallas_attention.py:55) for bf16.
// Grid (B * H, ceil(Sq / 64)); query tiles run last to first, since under
// the causal mask the last sees the most key tiles. Warp w owns query rows
// [16w, 16w + 16) of the tile; its Q fragments are loaded once and stay in
// registers; K/V tiles stream up to the causal bound; the online softmax
// runs in registers with row max over the 4-lane quad.
template <int D>
__global__ void __launch_bounds__(MT)
    fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o,
                   float* __restrict__ lse, int Sq, int Skv, int causal,
                   float scale) {
  constexpr int KS = D / 16;  // k-steps over the head dim
  constexpr int ND = D / 8;   // n-tiles over the head dim
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + 64 * D;      // two stages
  bf16* Vs = Ks + 2 * 64 * D;  // two stages

  const size_t bh = blockIdx.x;
  const int q_start = (gridDim.y - 1 - blockIdx.y) * BQ;
  const bf16* qp = q + bh * Sq * D;
  const bf16* kp = k + bh * Skv * D;
  const bf16* vp = v + bh * Skv * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int off = Skv - Sq;
  const int row0 = q_start + warp * 16 + g;  // this thread's rows: +0, +8
  const int nkb = key_tiles(q_start, Sq, Skv, causal);

  cp_tile<D>(Qs, qp, q_start, Sq);
  if (nkb > 0) {
    cp_tile<D>(Ks, kp, 0, Skv);
    cp_tile<D>(Vs, vp, 0, Skv);
  }
  cp_async_commit();

  uint32_t qf[KS][4];
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int kb = 0; kb < nkb; ++kb) {
    const int st = kb & 1;
    if (kb + 1 < nkb) {
      cp_tile<D>(Ks + (st ^ 1) * 64 * D, kp, (kb + 1) * BK, Skv);
      cp_tile<D>(Vs + (st ^ 1) * 64 * D, vp, (kb + 1) * BK, Skv);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile kb (and Q) have landed
    __syncthreads();
    if (kb == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldsm_x4(qf[ks],
                Qs + swz<D>(warp * 16 + a_row(lane), 2 * ks + a_chunk(lane)));
    }
    const bf16* Kt = Ks + st * 64 * D;
    const bf16* Vt = Vs + st * 64 * D;

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n-tiles.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4(b, Kt + swz<D>(np * 16 + b_row(lane), 2 * ks + b_chunk(lane)));
        mma_bf16(s[2 * np], qf[ks], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[ks], b[2], b[3]);
      }

    // Scale, mask (edge tiles only), online softmax.
    const int k0 = kb * BK;
    const bool edge =
        k0 + BK > Skv || (causal && k0 + BK - 1 > q_start + off);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (edge) {
          const int col = k0 + n * 8 + 2 * t + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (col >= Skv || (causal && col > row + off)) x = NEG_INF;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // (m - m_new) is exactly 0 when both are NEG_INF, as in the
      // reference's exp(m - m_new).
      const float alpha = exp2f((m[i] - mx[i]) * LOG2E);
      m[i] = mx[i];
      l[i] *= alpha;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][2 * i] *= alpha;
        acc[n][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((s[n][e] - m[e >> 1]) * LOG2E);
        s[n][e] = p;
        l[e >> 1] += p;  // this lane's share; the quad is summed at the end
      }

    // O += P V: P as bf16 A fragments straight from the accumulators.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dp = 0; dp < KS; ++dp) {
        uint32_t b[4];
        ldsm_x4_t(b,
                  Vt + swz<D>(16 * j + a_row(lane), 2 * dp + a_chunk(lane)));
        mma_bf16(acc[2 * dp], pa, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // stage st is refilled by the next iteration
  }
  cp_async_wait<0>();

  bf16* op = o + bh * Sq * D;
  float* lp = lse + bh * Sq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = row0 + 8 * i;
    if (row >= Sq) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];
    const float inv = 1.f / ls;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(op + (size_t)row * D + n * 8 + 2 * t) =
          pack_bf16(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    if (t == 0) lp[row] = m[i] + logf(ls);
  }
}

// -------------------------------------------------- tensor-core dK/dV ---
// Replaces _bwd_dkv_kernel (horovod_tpu/ops/pallas_attention.py:114) for
// bf16. Grid (B * H, ceil(Skv / 64)); key tiles run first to last, since
// under the causal mask the first is seen by the most query tiles. Warp w
// owns key rows [16w, 16w + 16) of the tile. Q/dO tiles (with their lse
// and delta rows) stream from the first query tile that sees the key tile.
// The block computes S^T = K Q^T and dP^T = V dO^T, then
// P^T = exp(scale S^T - lse) and dS^T = P^T (dP^T - delta), and
// accumulates dV += P^T dO and dK += dS^T Q in fp32 registers.
template <int D>
__global__ void __launch_bounds__(MT)
    dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int Sq, int Skv, int causal,
                   float scale) {
  constexpr int KS = D / 16;
  constexpr int ND = D / 8;
  // K/V A fragments live in registers up to D = 64; at D = 128 they would
  // take 64 more registers and spill, so they are re-read from shared
  // memory (where the tiles stay anyway).
  constexpr bool KV_REGS = D <= 64;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + 64 * D;
  bf16* Qs = Vs + 64 * D;        // two stages
  bf16* dOs = Qs + 2 * 64 * D;   // two stages
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * 64 * D);  // [2][64]
  float* delta_s = lse_s + 2 * BQ;                            // [2][64]

  const size_t bh = blockIdx.x;
  const int k_start = blockIdx.y * BK;
  const bf16* qp = q + bh * Sq * D;
  const bf16* dop = dout + bh * Sq * D;
  const bf16* kp = k + bh * Skv * D;
  const bf16* vp = v + bh * Skv * D;
  const float* lsep = lse + bh * Sq;
  const float* deltap = delta + bh * Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int off = Skv - Sq;
  const int key0 = k_start + warp * 16 + g;  // this thread's keys: +0, +8

  const int nqb = (Sq + BQ - 1) / BQ;
  int qb0 = 0;
  if (causal) {
    // Query rows r with r + (Skv - Sq) >= k_start see this key tile.
    const int first = k_start - off;
    qb0 = (first > 0 ? first : 0) / BQ;
  }

  // Q, dO, lse and delta of query tile qb into stage st. Rows past Sq get
  // lse = +inf and delta = 0, so they contribute nothing.
  auto load_q_tile = [&](int qb, int st) {
    cp_tile<D>(Qs + st * 64 * D, qp, qb * BQ, Sq);
    cp_tile<D>(dOs + st * 64 * D, dop, qb * BQ, Sq);
    if (threadIdx.x < BQ) {
      const int r = threadIdx.x, gr = qb * BQ + r;
      if (gr < Sq) {
        cp_async4(lse_s + st * BQ + r, lsep + gr);
        cp_async4(delta_s + st * BQ + r, deltap + gr);
      } else {
        lse_s[st * BQ + r] = INFINITY;
        delta_s[st * BQ + r] = 0.f;
      }
    }
  };

  cp_tile<D>(Ks, kp, k_start, Skv);
  cp_tile<D>(Vs, vp, k_start, Skv);
  if (qb0 < nqb) load_q_tile(qb0, 0);
  cp_async_commit();

  float dK[ND][4], dV[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dK[n][e] = dV[n][e] = 0.f;
  uint32_t kf[KV_REGS ? KS : 1][4], vf[KV_REGS ? KS : 1][4];
  const int a_off_row = warp * 16 + a_row(lane);

  for (int qb = qb0; qb < nqb; ++qb) {
    const int st = (qb - qb0) & 1;
    if (qb + 1 < nqb) load_q_tile(qb + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // query tile qb (and K, V) have landed
    __syncthreads();
    if constexpr (KV_REGS) {
      if (qb == qb0) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          ldsm_x4(kf[ks], Ks + swz<D>(a_off_row, 2 * ks + a_chunk(lane)));
          ldsm_x4(vf[ks], Vs + swz<D>(a_off_row, 2 * ks + a_chunk(lane)));
        }
      }
    }
    const bf16* Qt = Qs + st * 64 * D;
    const bf16* dOt = dOs + st * 64 * D;
    const float* Lt = lse_s + st * BQ;
    const float* Dt = delta_s + st * BQ;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x 64 query rows per warp.
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ka[4], va[4];
      if constexpr (KV_REGS) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ka[i] = kf[ks][i];
          va[i] = vf[ks][i];
        }
      } else {
        ldsm_x4(ka, Ks + swz<D>(a_off_row, 2 * ks + a_chunk(lane)));
        ldsm_x4(va, Vs + swz<D>(a_off_row, 2 * ks + a_chunk(lane)));
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        const int at = swz<D>(np * 16 + b_row(lane), 2 * ks + b_chunk(lane));
        ldsm_x4(b, Qt + at);
        mma_bf16(s[2 * np], ka, b[0], b[1]);
        mma_bf16(s[2 * np + 1], ka, b[2], b[3]);
        ldsm_x4(b, dOt + at);
        mma_bf16(dp[2 * np], va, b[0], b[1]);
        mma_bf16(dp[2 * np + 1], va, b[2], b[3]);
      }
    }

    // P^T and dS^T in fp32; masked only where an edge cuts the tile.
    const int q_start = qb * BQ;
    const bool edge = q_start + BQ > Sq || k_start + BK > Skv ||
                      (causal && k_start + BK - 1 > q_start + off);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = n * 8 + 2 * t;
      const float2 L = *reinterpret_cast<const float2*>(Lt + c);
      const float2 Dl = *reinterpret_cast<const float2*>(Dt + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lse_c = (e & 1) ? L.y : L.x;
        const float delta_c = (e & 1) ? Dl.y : Dl.x;
        float p = exp2f((s[n][e] * scale - lse_c) * LOG2E);
        if (edge && !visible(q_start + c + (e & 1), key0 + (e >> 1) * 8, Sq,
                             Skv, causal))
          p = 0.f;
        dp[n][e] = p * (dp[n][e] - delta_c);
        s[n][e] = p;
      }
    }

    // dV += P^T dO and dK += dS^T Q, with P^T and dS^T as bf16 A
    // fragments straight from the accumulators.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      const uint32_t da[4] = {pack_bf16(dp[2 * j][0], dp[2 * j][1]),
                              pack_bf16(dp[2 * j][2], dp[2 * j][3]),
                              pack_bf16(dp[2 * j + 1][0], dp[2 * j + 1][1]),
                              pack_bf16(dp[2 * j + 1][2], dp[2 * j + 1][3])};
#pragma unroll
      for (int dpair = 0; dpair < KS; ++dpair) {
        uint32_t b[4];
        const int at =
            swz<D>(16 * j + a_row(lane), 2 * dpair + a_chunk(lane));
        ldsm_x4_t(b, dOt + at);
        mma_bf16(dV[2 * dpair], pa, b[0], b[1]);
        mma_bf16(dV[2 * dpair + 1], pa, b[2], b[3]);
        ldsm_x4_t(b, Qt + at);
        mma_bf16(dK[2 * dpair], da, b[0], b[1]);
        mma_bf16(dK[2 * dpair + 1], da, b[2], b[3]);
      }
    }
    __syncthreads();  // stage st is refilled by the next iteration
  }
  cp_async_wait<0>();

  bf16* dkp = dk + bh * Skv * D;
  bf16* dvp = dv + bh * Skv * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= Skv) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const size_t at = (size_t)key * D + n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dkp + at) =
          pack_bf16(dK[n][2 * i] * scale, dK[n][2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvp + at) =
          pack_bf16(dV[n][2 * i], dV[n][2 * i + 1]);
    }
  }
}

// ----------------------------------------------------- tensor-core dQ ---
// Replaces _bwd_dq_kernel (horovod_tpu/ops/pallas_attention.py:174) for
// bf16. The forward's structure with dK/dV's math: grid (B * H,
// ceil(Sq / 64)), query tiles last to first; warp w owns query rows
// [16w, 16w + 16); the Q and dO tiles are loaded once and their A
// fragments stay in registers, each thread keeps its two rows' lse and
// delta in registers, and K/V tiles stream up to the causal bound. Each
// key tile is taken in two passes of 32 keys: S = Q K^T and dP = dO V^T,
// P = exp(scale S - lse) and dS = P (dP - delta) in fp32 registers, then
// dQ += dS K with dS as bf16 A fragments straight from the accumulators
// and K read through ldmatrix.trans (as the forward reads V). One block
// writes each dQ row.
template <int D>
__global__ void __launch_bounds__(MT)
    dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq,
                  int Sq, int Skv, int causal, float scale) {
  constexpr int KS = D / 16;
  constexpr int ND = D / 8;
  // Keys per pass. A whole 64-key tile's S and dP take 64 registers
  // beside the Q/dO fragments and the dQ accumulator; at D = 64 ptxas then
  // caps the kernel at 168 registers (3 blocks an SM) and spills. Passes of
  // 32 keys fit without a spill at every D (PERF.md has the counts).
  constexpr int KP = 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + 64 * D;
  bf16* Ks = dOs + 64 * D;      // two stages
  bf16* Vs = Ks + 2 * 64 * D;   // two stages

  const size_t bh = blockIdx.x;
  const int q_start = (gridDim.y - 1 - blockIdx.y) * BQ;
  const bf16* kp = k + bh * Skv * D;
  const bf16* vp = v + bh * Skv * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int off = Skv - Sq;
  const int row0 = q_start + warp * 16 + g;  // this thread's rows: +0, +8
  const int nkb = key_tiles(q_start, Sq, Skv, causal);

  cp_tile<D>(Qs, q + bh * Sq * D, q_start, Sq);
  cp_tile<D>(dOs, dout + bh * Sq * D, q_start, Sq);
  if (nkb > 0) {
    cp_tile<D>(Ks, kp, 0, Skv);
    cp_tile<D>(Vs, vp, 0, Skv);
  }
  cp_async_commit();

  // p = exp2(s * scale log2 e - lse log2 e), one FMA before exp2. Rows
  // past Sq get lse = +inf and delta = 0, so they contribute nothing.
  const float sl2 = scale * LOG2E;
  float nl2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    nl2[i] = row < Sq ? -lse[bh * Sq + row] * LOG2E : -INFINITY;
    dl[i] = row < Sq ? delta[bh * Sq + row] : 0.f;
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  uint32_t qf[KS][4], of[KS][4];
  const int a_off_row = warp * 16 + a_row(lane);

  for (int kb = 0; kb < nkb; ++kb) {
    const int st = kb & 1;
    if (kb + 1 < nkb) {
      cp_tile<D>(Ks + (st ^ 1) * 64 * D, kp, (kb + 1) * BK, Skv);
      cp_tile<D>(Vs + (st ^ 1) * 64 * D, vp, (kb + 1) * BK, Skv);
    }
    cp_async_commit();
    cp_async_wait<1>();  // key tile kb (and Q, dO) have landed
    __syncthreads();
    if (kb == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        ldsm_x4(qf[ks], Qs + swz<D>(a_off_row, 2 * ks + a_chunk(lane)));
        ldsm_x4(of[ks], dOs + swz<D>(a_off_row, 2 * ks + a_chunk(lane)));
      }
    }
    const bf16* Kt = Ks + st * 64 * D;
    const bf16* Vt = Vs + st * 64 * D;
    const int k0 = kb * BK;
    const bool edge =
        k0 + BK > Skv || (causal && k0 + BK - 1 > q_start + off);

#pragma unroll
    for (int kr = 0; kr < BK; kr += KP) {
      // S = Q K^T and dP = dO V^T: 16 rows x KP keys per warp.
      float s[KP / 8][4], dp[KP / 8][4];
#pragma unroll
      for (int n = 0; n < KP / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int np = 0; np < KP / 16; ++np) {
          uint32_t b[4];
          const int at =
              swz<D>(kr + np * 16 + b_row(lane), 2 * ks + b_chunk(lane));
          ldsm_x4(b, Kt + at);
          mma_bf16(s[2 * np], qf[ks], b[0], b[1]);
          mma_bf16(s[2 * np + 1], qf[ks], b[2], b[3]);
          ldsm_x4(b, Vt + at);
          mma_bf16(dp[2 * np], of[ks], b[0], b[1]);
          mma_bf16(dp[2 * np + 1], of[ks], b[2], b[3]);
        }

      // P and dS in fp32; P is zeroed (not the score masked) only where
      // an edge cuts the tile: a row that sees no key has lse ~ NEG_INF.
#pragma unroll
      for (int n = 0; n < KP / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(s[n][e], sl2, nl2[e >> 1]));
          if (edge && !visible(row0 + (e >> 1) * 8,
                               k0 + kr + n * 8 + 2 * t + (e & 1), Sq, Skv,
                               causal))
            p = 0.f;
          s[n][e] = p * (dp[n][e] - dl[e >> 1]);  // dS
        }

      // dQ += dS K: dS as bf16 A fragments, K read along its columns.
#pragma unroll
      for (int j = 0; j < KP / 16; ++j) {
        const uint32_t da[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                                pack_bf16(s[2 * j][2], s[2 * j][3]),
                                pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                                pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
        for (int dpair = 0; dpair < KS; ++dpair) {
          uint32_t b[4];
          ldsm_x4_t(b, Kt + swz<D>(kr + 16 * j + a_row(lane),
                                   2 * dpair + a_chunk(lane)));
          mma_bf16(acc[2 * dpair], da, b[0], b[1]);
          mma_bf16(acc[2 * dpair + 1], da, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // stage st is refilled by the next iteration
  }
  cp_async_wait<0>();

  bf16* dqp = dq + bh * Sq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= Sq) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(dqp + (size_t)row * D + n * 8 + 2 * t) =
          pack_bf16(acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
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

// Tensor-core tiles: fwd Q + two stages of K and V; dK/dV K, V + two
// stages of Q and dO, plus two stages of lse and delta rows; dQ Q, dO +
// two stages of K and V (lse and delta stay in registers).
template <int D> constexpr size_t fwd_mma_smem() {
  return sizeof(bf16) * 5 * 64 * D;
}
template <int D> constexpr size_t dkv_mma_smem() {
  return sizeof(bf16) * 6 * 64 * D + sizeof(float) * 4 * BQ;
}
template <int D> constexpr size_t dq_mma_smem() {
  return sizeof(bf16) * 6 * 64 * D;
}

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

// bf16 goes to the tensor-core kernels, fp32 to the FMA ones.
template <int D, typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int Sq, int Skv, int causal,
                       float scale, cudaStream_t st) {
  const int nqt = (Sq + BQ - 1) / BQ;
  if constexpr (std::is_same<T, bf16>::value) {
    return launch(fwd_mma_kernel<D>, dim3(B * H, nqt), MT, fwd_mma_smem<D>(),
                  st, (const bf16*)q, (const bf16*)k, (const bf16*)v,
                  (bf16*)o, (float*)lse, Sq, Skv, causal, scale);
  } else {
    return launch(fwd_kernel<D, T>, dim3(nqt, H, B), NT, fwd_smem<D>(), st,
                  (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse,
                  H, Sq, Skv, causal, scale);
  }
}

template <int D, typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int H, int Sq, int Skv,
                       int causal, float scale, cudaStream_t st) {
  const int nkt = (Skv + BK - 1) / BK;
  if constexpr (std::is_same<T, bf16>::value) {
    return launch(dkv_mma_kernel<D>, dim3(B * H, nkt), MT, dkv_mma_smem<D>(),
                  st, (const bf16*)q, (const bf16*)k, (const bf16*)v,
                  (const bf16*)dout, (const float*)lse, (const float*)delta,
                  (bf16*)dk, (bf16*)dv, Sq, Skv, causal, scale);
  } else {
    return launch(dkv_kernel<D, T>, dim3(nkt, H, B), NT, dkv_smem<D>(), st,
                  (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
                  (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, H,
                  Sq, Skv, causal, scale);
  }
}

template <int D, typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int H, int Sq, int Skv, int causal,
                      float scale, cudaStream_t st) {
  const int nqt = (Sq + BQ - 1) / BQ;
  if constexpr (std::is_same<T, bf16>::value) {
    return launch(dq_mma_kernel<D>, dim3(B * H, nqt), MT, dq_mma_smem<D>(),
                  st, (const bf16*)q, (const bf16*)k, (const bf16*)v,
                  (const bf16*)dout, (const float*)lse, (const float*)delta,
                  (bf16*)dq, Sq, Skv, causal, scale);
  } else {
    return launch(dq_kernel<D, T>, dim3(nqt, H, B), NT, dq_smem<D>(), st,
                  (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
                  (const float*)lse, (const float*)delta, (T*)dq, H, Sq,
                  Skv, causal, scale);
  }
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
