// Flash attention for Hopper (sm_90a): forward, dK/dV and dQ kernels.
//
// Built by horovod_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through the plain C entry points at the bottom of this file
// (ctypes); flash_common.cuh holds the helpers it shares with
// flash_attention_wide.cu (head dims above 128), hopper_common.cuh the
// Hopper pieces (mbarriers, TMA, wgmma, the stall record), hopper_fwd.cuh
// the Hopper forward (fwd_wgmma_kernel) and hopper_bwd.cuh the Hopper
// backward (dkv_rows_wgmma_kernel, dq_rows_wgmma_kernel); the wide library
// also runs the forward and dQ at head dims 192 and 256. Every tensor is a
// contiguous (B, H, S, D) panel, D one of 16, 32, 64, 128;
// lse and delta are contiguous (B, H, Sq) fp32. Inputs are fp32, bf16 or
// fp16, every sum is fp32, outputs take the inputs' type (lse stays fp32).
//
// Semantics are those of horovod_tpu/ops/pallas_attention.py: the causal
// mask uses the decode convention (query row r has absolute position
// r + Skv - Sq), masked scores are NEG_INF = -1e30 (not -inf, so a fully
// masked key block behaves as in the TPU kernel), key columns >= Skv are
// masked, and a row with l == 0 divides by 1. Query rows that see no key
// (causal, Sq > Skv) get one convention on every forward route: O the mean
// of V, lse NEG_INF + log Skv (none_rows_kernel, flash_common.cuh).
//
// Two designs. bf16 and fp16 run the Hopper kernels, each a producer
// warpgroup that keeps TMA loads in flight in an mbarrier ring and two
// consumer warpgroups that issue wgmma and take turns: the forward
// (hopper_fwd.cuh, fwd_wgmma_kernel), dK/dV (hopper_bwd.cuh,
// dkv_rows_wgmma_kernel: 128 keys a block, each warpgroup 64 of them with
// their K, V, dK and dV, Q and dO streamed; the score products and, with
// P^T and dS^T as register operands, dV and dK) and dQ
// (dq_rows_wgmma_kernel: 128 query rows a block, each warpgroup 64 of them
// with their Q, dO and dQ, K and V streamed), on the fixed tiles of
// flash_attention.py's FWD_TILES and BWD_TILES. The bf16/fp16 backward
// kernels wait with mbar_wait_bounded (their consumers take setmaxnreg's
// registers, which a trap in the branch would take away), so a stalled
// pipeline records the stall instead of trapping, and every entry point
// then refuses (arm_stall_word, hopper_common.cuh).
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

#include "hopper_bwd.cuh"

#include <type_traits>

namespace {

using namespace hvd_flash;

constexpr int TX = 16;          // FMA thread grid: 16 x 16
constexpr int TY = 16;
constexpr int NT = TX * TY;     // 256 threads per FMA block
constexpr int RI = BQ / TY;     // rows of a score tile per thread
constexpr int CJ = BK / TX;     // columns of a score tile per thread
constexpr int LP = 65;          // row stride of a 64x64 score tile in smem

static_assert(BQ == BK, "tile loads assume square score tiles");

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
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

// bf16 and fp16 go to the Hopper kernels, fp32 to the FMA ones.
template <typename T>
constexpr bool kTensorCore =
    std::is_same<T, bf16>::value || std::is_same<T, f16>::value;

// Dynamic shared memory of kernel `which` (0 forward, 1 dK/dV, 2 dQ).
template <int D, typename T>
size_t smem_bytes(int which) {
  if constexpr (kTensorCore<T>) {
    return which == 0 ? HopperFwd<D>::SMEM
           : which == 1 ? HopperDkv<D>::SMEM : HopperDq<D>::SMEM;
  } else {
    return which == 0 ? fwd_smem<D>()
           : which == 1 ? dkv_smem<D>() : dq_smem<D>();
  }
}

// The fixed tile of the bf16/fp16 kernel `which` (0 forward, 1 dK/dV,
// 2 dQ) at head dim D: query rows * 65536 + keys, as FWD_TILES and
// BWD_TILES in flash_attention.py state it.
template <int D>
int tile(int which) {
  return which == 0 ? HopperFwd<D>::HM << 16 | HopperFwd<D>::HN
         : which == 1 ? HopperDkv<D>::BM << 16 | HopperDkv<D>::HK
                      : HopperDq<D>::HM << 16 | HopperDq<D>::HN;
}

template <int D, typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int Sq, int Skv, int causal,
                       float scale, cudaStream_t st) {
  cudaError_t err;
  if constexpr (kTensorCore<T>) {
    err = launch_fwd_wgmma<D, T>(q, k, v, o, lse, B, H, Sq, Skv, causal,
                                 scale, st);
  } else {
    const int nqt = (Sq + BQ - 1) / BQ;
    err = launch(fwd_kernel<D, T>, dim3(nqt, H, B), NT, fwd_smem<D>(), st,
                 (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse,
                 H, Sq, Skv, causal, scale);
  }
  // Rows that see no key take the one convention (flash_common.cuh).
  if (err != cudaSuccess) return err;
  return launch_none_rows<T>(v, o, lse, B, H, Sq, Skv, D, causal, st);
}

template <int D, typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int H, int Sq, int Skv,
                       int causal, float scale, cudaStream_t st) {
  if constexpr (kTensorCore<T>) {
    if (const cudaError_t err = arm_stall_word()) return err;
    return launch_dkv_rows<D, T>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq,
                                 Skv, causal, scale, st);
  } else {
    const int nkt = (Skv + BK - 1) / BK;
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
  if constexpr (kTensorCore<T>) {
    if (const cudaError_t err = arm_stall_word()) return err;
    return launch_dq_rows<D, T>(q, k, v, dout, lse, delta, dq, B, H, Sq, Skv,
                                causal, scale, st);
  } else {
    const int nqt = (Sq + BQ - 1) / BQ;
    return launch(dq_kernel<D, T>, dim3(nqt, H, B), NT, dq_smem<D>(), st,
                  (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
                  (const float*)lse, (const float*)delta, (T*)dq, H, Sq,
                  Skv, causal, scale);
  }
}

}  // namespace

// Dispatch on (head_dim, dtype); an unsupported pair is
// cudaErrorInvalidValue, which the Python wrapper raises on. Once a bounded
// wait of this library has given up (hopper_common.cuh), every entry point
// returns cudaErrorLaunchTimeout.
#define HVD_DTYPES(DD, DT_, CALL)                             \
  if (DT_ == kF32) return (int)CALL(DD, float);               \
  if (DT_ == kBF16) return (int)CALL(DD, __nv_bfloat16);      \
  if (DT_ == kF16) return (int)CALL(DD, __half);              \
  break
#define HVD_DISPATCH(D_, DT_, CALL)                           \
  do {                                                        \
    switch (D_) {                                             \
      case 16: HVD_DTYPES(16, DT_, CALL);                     \
      case 32: HVD_DTYPES(32, DT_, CALL);                     \
      case 64: HVD_DTYPES(64, DT_, CALL);                     \
      case 128: HVD_DTYPES(128, DT_, CALL);                   \
    }                                                         \
    return (int)cudaErrorInvalidValue;                        \
  } while (0)

extern "C" {

const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int hvd_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int B, int H, int Sq, int Skv, int D, int dtype,
                  int causal, float scale, void* stream) {
  if (stalled()) return (int)cudaErrorLaunchTimeout;
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
  if (stalled()) return (int)cudaErrorLaunchTimeout;
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
  if (stalled()) return (int)cudaErrorLaunchTimeout;
#define CALL(DD, TT)                                                    \
  launch_dq<DD, TT>(q, k, v, dout, lse, delta, dq, B, H, Sq, Skv, causal, \
                    scale, (cudaStream_t)stream)
  HVD_DISPATCH(D, dtype, CALL);
#undef CALL
}

// Dynamic shared memory (bytes) that kernel `which` (0 forward, 1 dK/dV,
// 2 dQ) launches with at head dim D in dtype.
int hvd_flash_smem(int which, int D, int dtype) {
#define CALL(DD, TT) smem_bytes<DD, TT>(which)
  HVD_DISPATCH(D, dtype, CALL);
#undef CALL
}

// The fixed (query rows, keys) tile of the bf16/fp16 kernel `which`
// (0 forward, 1 dK/dV, 2 dQ) at head dim D, as rows * 65536 + keys; 0 at a
// head dim this library does not compile.
int hvd_flash_tile(int which, int D) {
  switch (D) {
    case 16: return tile<16>(which);
    case 32: return tile<32>(which);
    case 64: return tile<64>(which);
    case 128: return tile<128>(which);
  }
  return 0;
}

}  // extern "C"
