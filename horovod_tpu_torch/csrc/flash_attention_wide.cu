// Flash attention at head dims above 128 on Hopper (sm_90a): forward,
// dK/dV and dQ kernels, in fp32, bf16 and fp16.
//
// Built by horovod_tpu_torch/ops/_build.py into its own library (beside
// flash_attention.cu's, which holds the head dims 16-128) and bound
// through the plain C entry points at the bottom (ctypes), which take the
// names and arguments of flash_attention.cu's. Every tensor is
// a contiguous (B, H, S, D) panel with D a multiple of 64 above 128 (the
// wrapper pads other head dims up, ops/flash_attention.py
// padded_head_dim); lse and delta are contiguous (B, H, Sq) fp32.
//
// They replace the same TPU kernels as flash_attention.cu's and compute
// the same function: _fwd_kernel (horovod_tpu/ops/pallas_attention.py:55),
// _bwd_dkv_kernel (:114) and _bwd_dq_kernel (:174), with the decode
// convention's causal mask, NEG_INF = -1e30 masking (fully masked key
// tiles included), an fp32 lse, and a row with l == 0 divided by 1.
//
// Two designs.
//
// The bf16/fp16 forward is written for Hopper (wgmma for both products,
// TMA loads, a producer warpgroup that keeps K and V in flight in an
// mbarrier ring, Q resident) and computes the scores once per (query tile,
// key tile). At D = 192 and 256 it is fwd_wgmma_kernel (hopper_fwd.cuh),
// whose two consumer warpgroups each hold 64 query rows' whole O (96 or
// 128 fp32 a thread) and take turns issuing their products. Above, O is
// too wide for that, and wide_fwd_wgmma_kernel (D = 320 to 576) holds one
// 64-row query tile a block:
//  - Columns. Warpgroup c owns columns [c D / 2, (c + 1) D / 2) of O for
//    all 64 rows (80 to 144 fp32 registers a thread), and the scores of
//    half of each key tile's keys over the whole head dim. Per tile of HN
//    keys: each warpgroup computes S for its HN / 2 keys (wgmma, Q and K
//    from shared memory), writes its row maxima to shared memory; after a
//    named barrier both take the same new max, and each computes its
//    keys' P in base 2 (one FMA and one ex2 a score, with the none-row
//    rule of fwd_wgmma_kernel's softmax_tile), stores it as T into a
//    double-buffered 64 x HN tile in shared memory and keeps its share of
//    the row sums; after a second barrier each issues O_c = alpha O_c +
//    P V[:, c-slice] (wgmma, P and V from shared memory, V MN-major).
//    The row sums are combined through shared memory at the end, and lse
//    is written by warpgroup 0.
//  - Overlap inside a warpgroup: tile j's S and tile j - 1's P V are
//    issued together, and the softmax of tile j runs while P V is in
//    flight. Nothing but wgmma writes an accumulator while a wgmma is in
//    flight (O is rescaled before the issue, masked scores are not written
//    back), or ptxas serializes the wgmma.
//  - The producer warpgroup gives up its registers (setmaxnreg), so that
//    a consumer thread may hold up to 240: ptxas takes that count only
//    where the branch holds no trap, so the kernel waits with
//    mbar_wait_bounded (tools/setmaxnreg_probe.py), which gives up after
//    10 s and records the stall in a word of mapped host memory; every
//    entry point refuses once it is set (arm_stall_word). Q and K come in
//    as boxes of 64 columns with the 128-byte swizzle, V as boxes of 64 or
//    32 columns (128- or 64-byte swizzle), so that each warpgroup's column
//    slice starts on a box.
//  - The tile is fixed per head dim (WideFwd below, flash_attention.py's
//    WIDE_FWD_TILES): 64 query rows and the most keys that two K and two
//    V stages beside Q and P leave room for.
//  - Blocks take their (head, query tile) from grouped_tile
//    (hopper_common.cuh): heads in groups whose K and V fit in L2, so that
//    K and V come from device memory once a group, not once a query
//    tile; both wide forwards do.
//
// The other kernels (the fp32 forward, the 16-bit forward above 576, and
// dK/dV and dQ in every dtype) split the OUTPUT's head-dim columns into
// slices of DS (128 where D is a multiple of 128, else 64; dK/dV always 64,
// since it keeps two accumulators) across a third grid dimension. Each
// block computes the scores, and in the backward dP = dO V^T, over the
// whole head dim, streaming Q/K (and dO/V) through shared memory in
// 64-column chunks, and accumulates only its own slice of O, of dK/dV or of
// dQ. Registers hold at most a 64-row x 128-column accumulator, as at
// D = 128, and shared memory holds chunks. The price is recomputing the
// scores once per slice: D / DS times the Q K^T product (and dO V^T),
// which the bound below does not count.
//  - Per tile of the streamed operand the block walks a sequence of items:
//    D / 64 chunk items (64 columns of each operand of the score products)
//    and one slice item (the DS columns of V, of dO and Q, or of K that the
//    output product reads). Items come in by cp.async into a two-stage
//    ring: item i + 1 is in flight while item i is multiplied.
//  - 16-bit types run every product on the tensor cores (mma.sync
//    m16n8k16, the tiles swizzled and read through ldmatrix, P and dS
//    rounded to T straight from the accumulators), as flash_attention.cu's
//    backward kernels do. fp32 stays fp32 on the FMA pipes (TF32 is too
//    coarse for the fp32 checks) with the same accumulator layout: each
//    thread sums the same (row, column) pairs, from padded fp32 tiles, and
//    P and dS pass through a per-warp shared scratch for their products.
//  - A block is 4 warps, each owning 16 rows of the 64-row tile.
// Every output element of every kernel is written by one block in a fixed
// order, with no atomics, so O, lse, dK/dV and dQ are bit-equal from run to
// run; the fp32 forward's lse is written by the blocks of slice 0.
// Bounds (the larger of bytes at 3.35 TB/s and the products the function
// needs at 989 TFLOP/s 16-bit, 67 TFLOP/s fp32) are computed per shape by
// chip_smoke.py; at D >= 192 every one of these kernels is bound by
// operations.

#include "hopper_fwd.cuh"

#include <mutex>
#include <type_traits>
#include <vector>

namespace {

using namespace hvd_flash;

constexpr int CW = 64;  // columns of a streamed chunk of the head dim

template <typename T>
constexpr bool kFp32 = std::is_same<T, float>::value;

// Row stride (elements) of a 64 x W tile in shared memory: 16-bit tiles are
// swizzled (swz) with no padding, fp32 tiles padded by 4 words, which
// keeps the FMA products' column reads free of bank conflicts and every
// row on a 16-byte boundary.
template <typename T, int W>
__host__ __device__ constexpr int tile_elems() {
  return 64 * (kFp32<T> ? W + 4 : W);
}

template <typename T, int W>
__device__ __forceinline__ int at(int row, int chunk) {
  if constexpr (kFp32<T>) {
    return row * (W + 4) + chunk * 4;
  } else {
    return swz<W>(row, chunk);
  }
}

// Rows [row0, row0 + 64) and columns [col0, col0 + W) of an (n_rows, D)
// panel into a tile by cp.async; rows past n_rows are zero.
template <typename T, int W>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int n_rows, int D, int col0) {
  constexpr int EPC = 16 / sizeof(T);  // elements of a 16-byte chunk
  constexpr int CPR = W / EPC;
#pragma unroll
  for (int i = 0; i < 64 * CPR / MT; ++i) {
    const int idx = threadIdx.x + i * MT;
    const int r = idx / CPR, c = idx % CPR;
    const int gr = row0 + r;
    const bool ok = gr < n_rows;
    cp_async16(dst + at<T, W>(r, c),
               src + (size_t)(ok ? gr : 0) * D + col0 + c * EPC, ok);
  }
}

// s += A B^T over one 64-column chunk: A and B are 64 x 64 tiles, the
// warp's 16 rows of A against all 64 rows of B. s[n][e] is row
// g + 8 (e >> 1), column 8 n + 2 t + (e & 1) of the warp's rows (the
// mma.sync accumulator layout).
template <typename T>
__device__ __forceinline__ void mm_abt(float (&s)[8][4], const T* A,
                                       const T* B, int warp, int lane) {
  if constexpr (kFp32<T>) {
    constexpr int LD = CW + 4;
    const int g = lane >> 2, t = lane & 3;
    const float* a0 = A + (warp * 16 + g) * LD;
    const float* a1 = a0 + 8 * LD;
    const float* b = B + 2 * t * LD;
#pragma unroll 4
    for (int kk = 0; kk < CW; ++kk) {
      const float x0 = a0[kk], x1 = a1[kk];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float y0 = b[n * 8 * LD + kk], y1 = b[(n * 8 + 1) * LD + kk];
        s[n][0] = fmaf(x0, y0, s[n][0]);
        s[n][1] = fmaf(x0, y1, s[n][1]);
        s[n][2] = fmaf(x1, y0, s[n][2]);
        s[n][3] = fmaf(x1, y1, s[n][3]);
      }
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < CW / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, A + swz<CW>(warp * 16 + a_row(lane), 2 * ks + a_chunk(lane)));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4(b, B + swz<CW>(np * 16 + b_row(lane), 2 * ks + b_chunk(lane)));
        mma16<T>(s[2 * np], a, b[0], b[1]);
        mma16<T>(s[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
}

// acc += P V: P (the warp's 16 rows x 64, in the accumulator layout) times
// V, a 64 x W tile read along its columns. 16-bit: P rounded to T as A
// fragments, V through ldmatrix.trans. fp32: P through the warp's scratch
// (16 x 68 words).
template <typename T, int W>
__device__ __forceinline__ void mm_pv(float (&acc)[W / 8][4],
                                      const float (&p)[8][4], const T* V,
                                      int warp, int lane, float* scratch) {
  if constexpr (kFp32<T>) {
    constexpr int LD = CW + 4;
    const int g = lane >> 2, t = lane & 3;
    float* ps = scratch + warp * 16 * LD;
    __syncwarp();  // the previous product's reads of ps are done
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ps[(g + (e >> 1) * 8) * LD + n * 8 + 2 * t + (e & 1)] = p[n][e];
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < 64; ++j) {
      const float p0 = ps[g * LD + j], p1 = ps[(g + 8) * LD + j];
      const float* vr = V + j * (W + 4) + 2 * t;
#pragma unroll
      for (int n = 0; n < W / 8; ++n) {
        const float2 y = *reinterpret_cast<const float2*>(vr + n * 8);
        acc[n][0] = fmaf(p0, y.x, acc[n][0]);
        acc[n][1] = fmaf(p0, y.y, acc[n][1]);
        acc[n][2] = fmaf(p1, y.x, acc[n][2]);
        acc[n][3] = fmaf(p1, y.y, acc[n][3]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t pa[4] = {pack16<T>(p[2 * j][0], p[2 * j][1]),
                              pack16<T>(p[2 * j][2], p[2 * j][3]),
                              pack16<T>(p[2 * j + 1][0], p[2 * j + 1][1]),
                              pack16<T>(p[2 * j + 1][2], p[2 * j + 1][3])};
#pragma unroll
      for (int dp = 0; dp < W / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4_t(b, V + swz<W>(16 * j + a_row(lane), 2 * dp + a_chunk(lane)));
        mma16<T>(acc[2 * dp], pa, b[0], b[1]);
        mma16<T>(acc[2 * dp + 1], pa, b[2], b[3]);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* dst, float a, float b) {
  if constexpr (kFp32<T>) {
    *reinterpret_cast<float2*>(dst) = make_float2(a, b);
  } else {
    *reinterpret_cast<uint32_t*>(dst) = pack16<T>(a, b);
  }
}

template <int W>
__device__ __forceinline__ void zero(float (&x)[W][4]) {
#pragma unroll
  for (int n = 0; n < W; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
}

// Shared memory: two stages of STAGE elements, then (fp32) the scratch.
template <typename T>
constexpr size_t scratch_bytes() {
  return kFp32<T> ? sizeof(float) * 4 * 16 * (CW + 4) : 0;
}
template <typename T, int DS>
__host__ __device__ constexpr int fwd_stage() {
  return 2 * tile_elems<T, CW>() > tile_elems<T, DS>()
             ? 2 * tile_elems<T, CW>()
             : tile_elems<T, DS>();
}
// Four chunks; a backward slice item is at most that.
template <typename T>
__host__ __device__ constexpr int bwd_stage() {
  return 4 * tile_elems<T, CW>();
}

// ------------------------------------------------------------- forward ---
// Grid (B * H, ceil(Sq / 64), D / DS); query tiles last to first. Per key
// tile: S over D / 64 chunk items (Q and K chunks), the online softmax,
// then O[:, slice] += P V[:, slice] from the slice item.
template <typename T, int DS>
__global__ void __launch_bounds__(MT)
    wide_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    float* __restrict__ lse, int Sq, int Skv, int D,
                    int causal, float scale) {
  constexpr int CH = tile_elems<T, CW>();
  constexpr int STAGE = fwd_stage<T, DS>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* stages = reinterpret_cast<T*>(smem_raw);
  float* scratch = reinterpret_cast<float*>(stages + 2 * STAGE);

  const size_t bh = blockIdx.x;
  const int q_start = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int col0 = blockIdx.z * DS;
  const T* qp = q + bh * Sq * D;
  const T* kp = k + bh * Skv * D;
  const T* vp = v + bh * Skv * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int off = Skv - Sq;
  const int row0 = q_start + warp * 16 + (lane >> 2);  // rows +0, +8
  const int nc = D / CW, per = nc + 1;
  const int nkb = key_tiles(q_start, Sq, Skv, causal);
  const int n_items = nkb * per;

  auto load_item = [&](int it) {
    T* st = stages + (it & 1) * STAGE;
    const int kb = it / per, c = it % per;
    if (c < nc) {
      load_tile<T, CW>(st, qp, q_start, Sq, D, c * CW);
      load_tile<T, CW>(st + CH, kp, kb * BK, Skv, D, c * CW);
    } else {
      load_tile<T, DS>(st, vp, kb * BK, Skv, D, col0);
    }
  };

  float acc[DS / 8][4], s[8][4];
  zero(acc);
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  if (n_items > 0) load_item(0);
  cp_async_commit();
  for (int kb = 0; kb < nkb; ++kb) {
    zero(s);
    for (int c = 0; c <= nc; ++c) {
      const int it = kb * per + c;
      if (it + 1 < n_items) load_item(it + 1);
      cp_async_commit();
      cp_async_wait<1>();  // item it has landed
      __syncthreads();
      const T* st = stages + (it & 1) * STAGE;
      if (c < nc) {
        mm_abt<T>(s, st, st + CH, warp, lane);
      } else {
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
          for (int n = 0; n < DS / 8; ++n) {
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
            l[e >> 1] += p;  // this lane's share; the quad is summed below
          }
        mm_pv<T, DS>(acc, s, st, warp, lane, scratch);
      }
      __syncthreads();  // stage it & 1 is refilled by the next item
    }
  }
  cp_async_wait<0>();

  T* op = o + bh * Sq * D + col0;
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
    for (int n = 0; n < DS / 8; ++n)
      store2<T>(op + (size_t)row * D + n * 8 + 2 * t, acc[n][2 * i] * inv,
                acc[n][2 * i + 1] * inv);
    if (t == 0 && blockIdx.z == 0) lp[row] = m[i] + logf(ls);
  }
}

// ------------------------------------------------------- backward dK/dV ---
// Grid (B * H, ceil(Skv / 64), D / 64); key tiles first to last. Per query
// tile (from the first that sees the key tile): S^T = K Q^T and
// dP^T = V dO^T over D / 64 chunk items (K, V, Q and dO chunks), then
// P^T = exp(scale S^T - lse), dS^T = P^T (dP^T - delta), and from the
// slice item dV[:, slice] += P^T dO[:, slice], dK[:, slice] +=
// dS^T Q[:, slice]; dK is scaled once at the end.
template <typename T>
__global__ void __launch_bounds__(MT)
    wide_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, int Sq, int Skv, int D, int causal,
                    float scale) {
  constexpr int DS = CW;
  constexpr int CH = tile_elems<T, CW>();
  constexpr int STAGE = bwd_stage<T>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* stages = reinterpret_cast<T*>(smem_raw);
  float* scratch = reinterpret_cast<float*>(stages + 2 * STAGE);

  const size_t bh = blockIdx.x;
  const int k_start = blockIdx.y * BK;
  const int col0 = blockIdx.z * DS;
  const T* qp = q + bh * Sq * D;
  const T* dop = dout + bh * Sq * D;
  const T* kp = k + bh * Skv * D;
  const T* vp = v + bh * Skv * D;
  const float* lsep = lse + bh * Sq;
  const float* deltap = delta + bh * Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int off = Skv - Sq;
  const int key0 = k_start + warp * 16 + (lane >> 2);  // keys +0, +8
  const int nc = D / CW, per = nc + 1;
  const int nqb = (Sq + BQ - 1) / BQ;
  int qb0 = 0;
  if (causal) {
    // Query rows r with r + (Skv - Sq) >= k_start see this key tile.
    const int first = k_start - off;
    qb0 = (first > 0 ? first : 0) / BQ;
  }
  const int n_items = (nqb > qb0 ? nqb - qb0 : 0) * per;

  auto load_item = [&](int it) {
    T* st = stages + (it & 1) * STAGE;
    const int qb = qb0 + it / per, c = it % per;
    if (c < nc) {
      load_tile<T, CW>(st, kp, k_start, Skv, D, c * CW);
      load_tile<T, CW>(st + CH, vp, k_start, Skv, D, c * CW);
      load_tile<T, CW>(st + 2 * CH, qp, qb * BQ, Sq, D, c * CW);
      load_tile<T, CW>(st + 3 * CH, dop, qb * BQ, Sq, D, c * CW);
    } else {
      load_tile<T, DS>(st, dop, qb * BQ, Sq, D, col0);
      load_tile<T, DS>(st + CH, qp, qb * BQ, Sq, D, col0);
    }
  };

  float dK[DS / 8][4], dV[DS / 8][4], s[8][4], dp[8][4];
  zero(dK);
  zero(dV);
  if (n_items > 0) load_item(0);
  cp_async_commit();
  for (int qb = qb0; qb < nqb; ++qb) {
    zero(s);
    zero(dp);
    for (int c = 0; c <= nc; ++c) {
      const int it = (qb - qb0) * per + c;
      if (it + 1 < n_items) load_item(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const T* st = stages + (it & 1) * STAGE;
      if (c < nc) {
        mm_abt<T>(s, st, st + 2 * CH, warp, lane);       // K Q^T
        mm_abt<T>(dp, st + CH, st + 3 * CH, warp, lane);  // V dO^T
      } else {
        // P^T and dS^T in fp32; masked only where an edge cuts the tile.
        // Rows past Sq get lse = +inf and delta = 0: they add nothing.
        const int q_start = qb * BQ;
        const bool edge = q_start + BQ > Sq || k_start + BK > Skv ||
                          (causal && k_start + BK - 1 > q_start + off);
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qrow = q_start + n * 8 + 2 * t + (e & 1);
            const float lse_c = qrow < Sq ? lsep[qrow] : INFINITY;
            const float delta_c = qrow < Sq ? deltap[qrow] : 0.f;
            float p = exp2f((s[n][e] * scale - lse_c) * LOG2E);
            if (edge && !visible(qrow, key0 + (e >> 1) * 8, Sq, Skv, causal))
              p = 0.f;
            dp[n][e] = p * (dp[n][e] - delta_c);
            s[n][e] = p;
          }
        mm_pv<T, DS>(dV, s, st, warp, lane, scratch);       // P^T dO
        mm_pv<T, DS>(dK, dp, st + CH, warp, lane, scratch);  // dS^T Q
      }
      __syncthreads();
    }
  }
  cp_async_wait<0>();

  T* dkp = dk + bh * Skv * D + col0;
  T* dvp = dv + bh * Skv * D + col0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= Skv) continue;
#pragma unroll
    for (int n = 0; n < DS / 8; ++n) {
      const size_t at_ = (size_t)key * D + n * 8 + 2 * t;
      store2<T>(dkp + at_, dK[n][2 * i] * scale, dK[n][2 * i + 1] * scale);
      store2<T>(dvp + at_, dV[n][2 * i], dV[n][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------- backward dQ ---
// Grid (B * H, ceil(Sq / 64), D / DS); query tiles last to first. Per key
// tile: S = Q K^T and dP = dO V^T over D / 64 chunk items (Q, K, dO and V
// chunks), P = exp(scale S - lse) and dS = P (dP - delta), then
// dQ[:, slice] += dS K[:, slice] from the slice item; dQ is scaled once at
// the end.
template <typename T, int DS>
__global__ void __launch_bounds__(MT)
    wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq,
                   int Sq, int Skv, int D, int causal, float scale) {
  constexpr int CH = tile_elems<T, CW>();
  constexpr int STAGE = bwd_stage<T>();
  static_assert(tile_elems<T, DS>() <= STAGE, "a K slice fits a stage");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* stages = reinterpret_cast<T*>(smem_raw);
  float* scratch = reinterpret_cast<float*>(stages + 2 * STAGE);

  const size_t bh = blockIdx.x;
  const int q_start = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int col0 = blockIdx.z * DS;
  const T* qp = q + bh * Sq * D;
  const T* dop = dout + bh * Sq * D;
  const T* kp = k + bh * Skv * D;
  const T* vp = v + bh * Skv * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int row0 = q_start + warp * 16 + (lane >> 2);  // rows +0, +8
  const int nc = D / CW, per = nc + 1;
  const int nkb = key_tiles(q_start, Sq, Skv, causal);
  const int n_items = nkb * per;

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

  auto load_item = [&](int it) {
    T* st = stages + (it & 1) * STAGE;
    const int kb = it / per, c = it % per;
    if (c < nc) {
      load_tile<T, CW>(st, qp, q_start, Sq, D, c * CW);
      load_tile<T, CW>(st + CH, kp, kb * BK, Skv, D, c * CW);
      load_tile<T, CW>(st + 2 * CH, dop, q_start, Sq, D, c * CW);
      load_tile<T, CW>(st + 3 * CH, vp, kb * BK, Skv, D, c * CW);
    } else {
      load_tile<T, DS>(st, kp, kb * BK, Skv, D, col0);
    }
  };

  float acc[DS / 8][4], s[8][4], dp[8][4];
  zero(acc);
  if (n_items > 0) load_item(0);
  cp_async_commit();
  for (int kb = 0; kb < nkb; ++kb) {
    zero(s);
    zero(dp);
    for (int c = 0; c <= nc; ++c) {
      const int it = kb * per + c;
      if (it + 1 < n_items) load_item(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const T* st = stages + (it & 1) * STAGE;
      if (c < nc) {
        mm_abt<T>(s, st, st + CH, warp, lane);            // Q K^T
        mm_abt<T>(dp, st + 2 * CH, st + 3 * CH, warp, lane);  // dO V^T
      } else {
        // P and dS in fp32; P is zeroed (not the score masked) only where
        // an edge cuts the tile: a row that sees no key has lse ~ NEG_INF.
        const int k0 = kb * BK;
        const bool edge = k0 + BK > Skv ||
                          (causal && k0 + BK - 1 > q_start + (Skv - Sq));
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2f(fmaf(s[n][e], sl2, nl2[e >> 1]));
            if (edge && !visible(row0 + (e >> 1) * 8,
                                 k0 + n * 8 + 2 * t + (e & 1), Sq, Skv,
                                 causal))
              p = 0.f;
            s[n][e] = p * (dp[n][e] - dl[e >> 1]);  // dS
          }
        mm_pv<T, DS>(acc, s, st, warp, lane, scratch);  // dS K
      }
      __syncthreads();
    }
  }
  cp_async_wait<0>();

  T* dqp = dq + bh * Sq * D + col0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= Sq) continue;
#pragma unroll
    for (int n = 0; n < DS / 8; ++n)
      store2<T>(dqp + (size_t)row * D + n * 8 + 2 * t, acc[n][2 * i] * scale,
                acc[n][2 * i + 1] * scale);
  }
}

// =============================================== Hopper forward (16-bit) ===
// The bf16/fp16 forward at head dims 320-576 (see the top of this file). NC
// consumer warpgroups split O's columns (W each) and each tile's keys (HW
// each); HN keys a K/V tile; P V is issued as one wgmma of N1 columns, or
// two (N1 + N2) where W is past wgmma's 256. V comes in boxes of AV columns
// so that every warpgroup's slice, and the second instruction's, starts on
// one.
template <int D>
struct WideFwd {
  static constexpr int NC = 2;
  static constexpr int THREADS = 128 * (NC + 1);  // + the producer
  static constexpr int HN = D <= 320 ? 64 : D <= 384 ? 48 : 32;
  static constexpr int HW = HN / NC;
  static constexpr int W = D / NC;
  static constexpr int N1 = W <= 256 ? W : 160;
  static constexpr int N2 = W - N1;
  static constexpr int AV = W % 64 == 0 ? 64 : 32;
  static constexpr int SWV = 2 * AV;  // V's swizzle = a V box row's bytes
  static constexpr int NBOX = D / 64;  // Q and K boxes across D
  static constexpr int NS = 2;         // K stages, and V stages
  static constexpr int Q_BYTES = 64 * D * 2;
  static constexpr int KV_BYTES = HN * D * 2;
  static constexpr int P_BYTES = 64 * HN * 2;
  static constexpr int RED_BYTES = 4 * 64 * NC;
  static constexpr int BAR_BYTES = 8 * (1 + 4 * NS);
  // Q, the K and V stages, two P tiles, the row exchange, barriers, and
  // room to align the base to 1024 bytes (the 128-byte swizzle's period).
  static constexpr int SMEM = Q_BYTES + 2 * NS * KV_BYTES + 2 * P_BYTES +
                              RED_BYTES + BAR_BYTES + 1024;
  static_assert(D % 64 == 0 && D >= 320 && D <= 576, "a wide head dim");
  static_assert(HW % 8 == 0 && HN % 16 == 0, "wgmma's N and K steps");
  static_assert(W % AV == 0 && N1 % AV == 0 && N1 <= 256 && N2 <= 256,
                "O's slices start on a V box");
  static_assert(SMEM <= 232448, "fits a block's shared memory");
};

// The consumer warpgroups' rendezvous (named barrier 1; the producer
// warpgroup takes no part).
template <int NC>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * NC) : "memory");
}

// S = Q K^T over this warpgroup's HW keys: D / 16 wgmma k-steps (Q and K
// both K-major, boxes of 64 columns HM = 64 or HN rows apart).
template <int D, typename T>
__device__ __forceinline__ void wide_issue_s(float (&s)[WideFwd<D>::HW / 2],
                                             uint64_t q_desc,
                                             uint64_t k_desc) {
  using L = WideFwd<D>;
#pragma unroll
  for (int b = 0; b < L::NBOX; ++b)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss<L::HW, T>(s, q_desc + ((b * 64 * 128 + ks * 32) >> 4),
                         k_desc + ((b * L::HN * 128 + ks * 32) >> 4),
                         (b | ks) != 0);
}

// O_c += P V[:, c-slice]: HN / 16 k-steps of 16 keys, P from its shared
// tile (blocks of 16 keys, 2048 bytes apart), V MN-major (16 keys are 16
// rows of SWV bytes; the descriptor's leading byte offset reaches the next
// box of AV columns).
template <int D, typename T>
__device__ __forceinline__ void wide_issue_pv(
    float (&o1)[WideFwd<D>::N1 / 2],
    float (&o2)[WideFwd<D>::N2 > 0 ? WideFwd<D>::N2 / 2 : 1], uint64_t p_desc,
    uint64_t v_desc) {
  using L = WideFwd<D>;
#pragma unroll
  for (int kk = 0; kk < L::HN / 16; ++kk) {
    wgmma_ss_t<L::N1, T>(o1, p_desc + ((kk * 2048) >> 4),
                         v_desc + ((kk * 16 * L::SWV) >> 4), 1);
    if constexpr (L::N2 > 0)
      wgmma_ss_t<L::N2, T>(
          o2, p_desc + ((kk * 2048) >> 4),
          v_desc + ((L::N1 / L::AV * L::HN * L::SWV + kk * 16 * L::SWV) >> 4),
          1);
  }
}

// Score e of group i (accumulator 4 i + e) as the softmax sees it: under
// MASK (edge tiles only) keys past Skv and, under the causal mask, past
// each row's position are NEG_INF. The accumulators are only read: a
// non-wgmma write to them makes ptxas serialize the wgmma pipeline.
template <bool MASK>
__device__ __forceinline__ float wide_score(float x, int i, int e, int k0,
                                            int row0, int Sq, int Skv,
                                            int causal, int t) {
  if constexpr (MASK) {
    const int col = k0 + i * 8 + 2 * t + (e & 1);
    const int row = row0 + (e >> 1) * 8;
    if (col >= Skv || (causal && col > row + Skv - Sq)) return NEG_INF;
  }
  return x;
}

// This warpgroup's row maxima over its keys of one tile (raw units), the
// quad reduced.
template <int HW, bool MASK>
__device__ __forceinline__ void wide_tile_max(const float (&s)[HW / 2],
                                              float (&mx)[2], int k0,
                                              int row0, int Sq, int Skv,
                                              int causal, int t) {
  float c[2][2] = {{NEG_INF, NEG_INF}, {NEG_INF, NEG_INF}};
#pragma unroll
  for (int i = 0; i < HW / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      c[e >> 1][e & 1] =
          fmaxf(c[e >> 1][e & 1], wide_score<MASK>(s[4 * i + e], i, e, k0,
                                                   row0, Sq, Skv, causal, t));
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = fmaxf(c[r][0], c[r][1]);
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    mx[r] = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  }
}

template <int N>
__device__ __forceinline__ void scale_rows(float (&acc)[N],
                                           const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    acc[4 * i] *= alpha[0];
    acc[4 * i + 1] *= alpha[0];
    acc[4 * i + 2] *= alpha[1];
    acc[4 * i + 3] *= alpha[1];
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(WideFwd<D>::THREADS, 1)
    wide_fwd_wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                          __grid_constant__ const CUtensorMap tk,
                          __grid_constant__ const CUtensorMap tv,
                          T* __restrict__ o, float* __restrict__ lse, int Sq,
                          int Skv, int causal, float scale) {
  using L = WideFwd<D>;
  constexpr int NS = L::NS, NC = L::NC, HN = L::HN, HW = L::HW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  T* Qs = reinterpret_cast<T*>(base);
  T* Ks = reinterpret_cast<T*>(base + L::Q_BYTES);  // NS stages
  T* Vs = reinterpret_cast<T*>(base + L::Q_BYTES + NS * L::KV_BYTES);
  unsigned char* Ps = base + L::Q_BYTES + 2 * NS * L::KV_BYTES;  // 2 tiles
  float* red = reinterpret_cast<float*>(Ps + 2 * L::P_BYTES);   // NC x 64
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(Ps + 2 * L::P_BYTES + L::RED_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + NS;
  uint64_t* k_empty = v_full + NS;
  uint64_t* v_empty = k_empty + NS;

  int bh, qt;
  grouped_tile((Sq + 63) / 64, Skv, D, bh, qt);
  const int q_start = qt * 64;
  const int nkb = key_tiles(q_start, Sq, Skv, causal, 64, HN);
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      // Released by lane 0 of each consumer warp.
      mbar_init(k_empty + s, 4 * NC);
      mbar_init(v_empty + s, 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NC) {
    // Producer: the warpgroup gives up its registers (setmaxnreg) and one
    // thread keeps the TMA loads in flight.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == NC * 128) {
      mbar_expect_tx(q_full, L::Q_BYTES);
      for (int b = 0; b < L::NBOX; ++b)
        tma_load(Qs + b * 64 * 64, &tq, q_full, b * 64, q_start, bh);
      for (int j = 0; j < nkb; ++j) {
        const int st = j % NS, ph = (j / NS) & 1;
        if (j >= NS) mbar_wait_bounded(k_empty + st, ph ^ 1);
        mbar_expect_tx(k_full + st, L::KV_BYTES);
        for (int b = 0; b < L::NBOX; ++b)
          tma_load(Ks + st * HN * D + b * HN * 64, &tk, k_full + st, b * 64,
                   j * HN, bh);
        if (j >= NS) mbar_wait_bounded(v_empty + st, ph ^ 1);
        mbar_expect_tx(v_full + st, L::KV_BYTES);
        for (int b = 0; b < D / L::AV; ++b)
          tma_load(Vs + st * HN * D + b * HN * L::AV, &tv, v_full + st,
                   b * L::AV, j * HN, bh);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns O's columns [wg W, (wg + 1) W) and keys
  // [wg HW, (wg + 1) HW) of each tile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rl0 = warp * 16 + g;  // this thread's local rows: +0, +8
  const int row0 = q_start + rl0;
  const float sl2 = scale * LOG2E;
  const uint64_t q_desc = gmma_desc(smem_u32(Qs), 16, 8 * 128, 128);
  const uint64_t k_desc =
      gmma_desc(smem_u32(Ks) + wg * HW * 128, 16, 8 * 128, 128);
  const uint64_t p_desc = gmma_desc(smem_u32(Ps), 16, 8 * 32, 32);
  const uint64_t v_desc =
      gmma_desc(smem_u32(Vs) + (wg * L::W / L::AV) * HN * L::SWV,
                HN * L::SWV, 8 * L::SWV, L::SWV);
  constexpr int KV_STEP = L::KV_BYTES >> 4;  // a stage, in 16 bytes
  constexpr int P_STEP = L::P_BYTES >> 4;
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  float s[HW / 2], o1[L::N1 / 2], o2[L::N2 > 0 ? L::N2 / 2 : 1];
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2] = {1.f, 1.f};
#pragma unroll
  for (int i = 0; i < L::N1 / 2; ++i) o1[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (L::N2 > 0 ? L::N2 / 2 : 1); ++i) o2[i] = 0.f;
  // P V of tile j (O rescaled first by the last softmax's correction).
  auto pv = [&](int j) {
    const int sp = j % NS;
    mbar_wait_bounded(v_full + sp, (j / NS) & 1);
    wgmma_fence();
    wide_issue_pv<D, T>(o1, o2, p_desc + (j & 1) * P_STEP,
                        v_desc + sp * KV_STEP);
    wgmma_commit();
  };

  mbar_wait_bounded(q_full, 0);
  for (int j = 0; j < nkb; ++j) {
    const int st = j % NS;
    // O is rescaled before the products are issued: a non-wgmma write to
    // an accumulator while a wgmma is in flight makes ptxas serialize them.
    if (j > 0) {
      scale_rows(o1, alpha);
      if constexpr (L::N2 > 0) scale_rows(o2, alpha);
    }
    mbar_wait_bounded(k_full + st, (j / NS) & 1);
    wgmma_fence();
    wide_issue_s<D, T>(s, q_desc, k_desc + st * KV_STEP);
    wgmma_commit();
    if (j > 0) {
      pv(j - 1);
      wgmma_wait<1>();  // S of tile j; P V of tile j - 1 may still run
    } else {
      wgmma_wait<0>();
    }
    pin(s);
    release(k_empty + st);

    // The row maxima over both warpgroups' keys.
    const int k0 = j * HN + wg * HW;
    const bool edge =
        k0 + HW > Skv || (causal && k0 + HW - 1 > q_start + (Skv - Sq));
    float mx[2];
    if (edge)
      wide_tile_max<HW, true>(s, mx, k0, row0, Sq, Skv, causal, t);
    else
      wide_tile_max<HW, false>(s, mx, k0, row0, Sq, Skv, causal, t);
    if (t == 0) {
      red[wg * 64 + rl0] = mx[0];
      red[wg * 64 + rl0 + 8] = mx[1];
    }
    consumers_sync<NC>();
    float mul[2], add[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = mx[r];
#pragma unroll
      for (int c = 0; c < NC; ++c) x = fmaxf(x, red[c * 64 + rl0 + 8 * r]);
      x = fmaxf(m[r], x);
      // (m - m_new) is exactly 0 when both are NEG_INF, as in the
      // reference's exp(m - m_new).
      alpha[r] = ex2((m[r] - x) * sl2);
      m[r] = x;
      // A row that has seen only masked keys keeps m = NEG_INF, and each of
      // its scores gives exp(NEG_INF - NEG_INF) = 1, as in the reference.
      const bool none = x == NEG_INF;
      mul[r] = none ? 0.f : sl2;
      add[r] = none ? 0.f : -x * sl2;
    }
    // P in base 2, this lane's share of the row sums, and P as T into the
    // shared tile j & 1: blocks of 16 keys, 64 rows of 32 bytes each, with
    // the 32-byte swizzle (the 16-byte half of a row flips every 4 rows).
    unsigned char* pt = Ps + (j & 1) * L::P_BYTES;
    float sum[2] = {0.f, 0.f};
    auto score = [&](int i, int e) {
      return edge ? wide_score<true>(s[4 * i + e], i, e, k0, row0, Sq, Skv,
                                     causal, t)
                  : s[4 * i + e];
    };
#pragma unroll
    for (int i = 0; i < HW / 8; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float p0 = ex2(fmaf(score(i, 2 * r), mul[r], add[r]));
        const float p1 = ex2(fmaf(score(i, 2 * r + 1), mul[r], add[r]));
        sum[r] += p0 + p1;
        const int key = wg * HW + i * 8 + 2 * t;
        const int row = rl0 + 8 * r;
        *reinterpret_cast<uint32_t*>(
            pt + (key >> 4) * 2048 + row * 32 +
            ((((key >> 3) ^ (row >> 2)) & 1) << 4) + (key & 7) * 2) =
            pack16<T>(p0, p1);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
    // The tile's stores reach wgmma's reads (the async proxy).
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (j > 0) {
      wgmma_wait<0>();
      pin(o1);
      pin(o2);
      release(v_empty + (j - 1) % NS);
    }
    consumers_sync<NC>();  // every warpgroup's share of P is stored
  }
  if (nkb > 0) {
    scale_rows(o1, alpha);
    if constexpr (L::N2 > 0) scale_rows(o2, alpha);
    pv(nkb - 1);
    wgmma_wait<0>();
    pin(o1);
    pin(o2);
    release(v_empty + (nkb - 1) % NS);
  }

  // The row sums of both warpgroups' keys, in a fixed order.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (t == 0) {
    red[wg * 64 + rl0] = l[0];
    red[wg * 64 + rl0 + 8] = l[1];
  }
  consumers_sync<NC>();
  T* op = o + (size_t)bh * Sq * D + wg * L::W;
  float* lp = lse + (size_t)bh * Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    float lt = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) lt += red[c * 64 + rl0 + 8 * r];
    const float ls = lt == 0.f ? 1.f : lt;
    const float inv = 1.f / ls;
    T* orow = op + (size_t)row * D + 2 * t;
#pragma unroll
    for (int i = 0; i < L::N1 / 8; ++i)
      *reinterpret_cast<uint32_t*>(orow + i * 8) =
          pack16<T>(o1[4 * i + 2 * r] * inv, o1[4 * i + 2 * r + 1] * inv);
    if constexpr (L::N2 > 0) {
#pragma unroll
      for (int i = 0; i < L::N2 / 8; ++i)
        *reinterpret_cast<uint32_t*>(orow + L::N1 + i * 8) =
            pack16<T>(o2[4 * i + 2 * r] * inv, o2[4 * i + 2 * r + 1] * inv);
    }
    if (wg == 0 && t == 0) lp[row] = m[r] * scale + logf(ls);
  }
}

template <int D, typename T>
cudaError_t launch_wide_fwd_wgmma(const void* q, const void* k,
                                  const void* v, void* o, void* lse, int B,
                                  int H, int Sq, int Skv, int causal,
                                  float scale, cudaStream_t st) {
  using L = WideFwd<D>;
  CUtensorMap tq, tk, tv;
  if (!tensor_map<T>(&tq, q, D, Sq, B * H, 64, 64, 128) ||
      !tensor_map<T>(&tk, k, D, Skv, B * H, 64, L::HN, 128) ||
      !tensor_map<T>(&tv, v, D, Skv, B * H, L::AV, L::HN, L::SWV))
    return cudaErrorInvalidValue;
  return launch(wide_fwd_wgmma_kernel<D, T>, dim3(B * H * ((Sq + 63) / 64)),
                L::THREADS, L::SMEM, st, tq, tk, tv, (T*)o, (float*)lse, Sq,
                Skv, causal, scale);
}

// The head dims the 16-bit Hopper forward is compiled for:
// fwd_wgmma_kernel (hopper_fwd.cuh, 128 query rows a block, each
// warpgroup's O whole) at 192 and 256, where O is at most 128 fp32 a
// thread; wide_fwd_wgmma_kernel (O's columns split across the warpgroups)
// from 320 to 576, the largest head dim of the catalog. A wider 16-bit
// forward runs wide_fwd_kernel, as fp32 does at every wide head dim: at
// 640 and above, half of O is 160 fp32 a thread or more, and Q beside two
// K and two V stages of 32 keys passes a block's shared memory, so the
// columns layout needs a third consumer warpgroup and another tile
// (ROADMAP B.3.1).
#define HVD_ROWS_FWD_DIMS(X) X(192) X(256)
#define HVD_WIDE_FWD_DIMS(X) X(320) X(384) X(448) X(512) X(576)

// ------------------------------------------------------------- launchers ---

template <typename T, int DS>
constexpr size_t fwd_smem() {
  return 2 * sizeof(T) * fwd_stage<T, DS>() + scratch_bytes<T>();
}
template <typename T>
constexpr size_t bwd_smem() {
  return 2 * sizeof(T) * bwd_stage<T>() + scratch_bytes<T>();
}

bool wide_dim(int D) { return D > 128 && D % CW == 0; }

// The mapped host word behind g_stall_word (hopper_common.cuh): made at the
// first 16-bit forward, and given to each device before its first one.
// Nonzero once a bounded wait of any launch has given up; every entry point
// then returns cudaErrorLaunchTimeout.
std::mutex stall_mutex;
unsigned* stall_host = nullptr;
std::vector<char> stall_armed;

bool stalled() {
  return stall_host && *reinterpret_cast<volatile unsigned*>(stall_host);
}

cudaError_t arm_stall_word() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(stall_mutex);
  if (!stall_host) {
    void* p = nullptr;
    err = cudaHostAlloc(&p, sizeof(unsigned),
                        cudaHostAllocMapped | cudaHostAllocPortable);
    if (err != cudaSuccess) return err;
    stall_host = static_cast<unsigned*>(p);
    *stall_host = 0;
  }
  if ((int)stall_armed.size() <= dev) stall_armed.resize(dev + 1, 0);
  if (!stall_armed[dev]) {
    void* dptr = nullptr;
    err = cudaHostGetDevicePointer(&dptr, stall_host, 0);
    if (err == cudaSuccess)
      err = cudaMemcpyToSymbol(g_stall_word, &dptr, sizeof(dptr));
    if (err != cudaSuccess) return err;
    stall_armed[dev] = 1;
  }
  return cudaSuccess;
}

// The route is chosen by dtype and head dim: bf16 and fp16 at the head
// dims of HVD_ROWS_FWD_DIMS and HVD_WIDE_FWD_DIMS to the Hopper forward,
// every other wide head dim and dtype to wide_fwd_kernel (O's columns
// sliced across the grid).
template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int Sq, int Skv, int D,
                       int causal, float scale, cudaStream_t st) {
  if (!wide_dim(D)) return cudaErrorInvalidValue;
  if constexpr (!kFp32<T>) {
    if (const cudaError_t err = arm_stall_word()) return err;
    switch (D) {
#define HVD_CASE(DD)                                                       \
  case DD:                                                                 \
    return launch_fwd_wgmma<DD, T>(q, k, v, o, lse, B, H, Sq, Skv, causal, \
                                   scale, st);
      HVD_ROWS_FWD_DIMS(HVD_CASE)
#undef HVD_CASE
#define HVD_CASE(DD)                                                        \
  case DD:                                                                  \
    return launch_wide_fwd_wgmma<DD, T>(q, k, v, o, lse, B, H, Sq, Skv,     \
                                        causal, scale, st);
      HVD_WIDE_FWD_DIMS(HVD_CASE)
#undef HVD_CASE
    }
  }
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ, D % 128 == 0 ? D / 128 : D / 64);
  if (D % 128 == 0)
    return launch(wide_fwd_kernel<T, 128>, grid, MT, fwd_smem<T, 128>(), st,
                  (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse,
                  Sq, Skv, D, causal, scale);
  return launch(wide_fwd_kernel<T, 64>, grid, MT, fwd_smem<T, 64>(), st,
                (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse,
                Sq, Skv, D, causal, scale);
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int H, int Sq, int Skv,
                       int D, int causal, float scale, cudaStream_t st) {
  if (!wide_dim(D)) return cudaErrorInvalidValue;
  return launch(wide_dkv_kernel<T>, dim3(B * H, (Skv + BK - 1) / BK, D / CW),
                MT, bwd_smem<T>(), st, (const T*)q, (const T*)k,
                (const T*)v, (const T*)dout, (const float*)lse,
                (const float*)delta, (T*)dk, (T*)dv, Sq, Skv, D, causal,
                scale);
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int H, int Sq, int Skv, int D,
                      int causal, float scale, cudaStream_t st) {
  if (!wide_dim(D)) return cudaErrorInvalidValue;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ, D % 128 == 0 ? D / 128 : D / 64);
  if (D % 128 == 0)
    return launch(wide_dq_kernel<T, 128>, grid, MT, bwd_smem<T>(), st,
                  (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
                  (const float*)lse, (const float*)delta, (T*)dq, Sq, Skv, D,
                  causal, scale);
  return launch(wide_dq_kernel<T, 64>, grid, MT, bwd_smem<T>(), st,
                (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
                (const float*)lse, (const float*)delta, (T*)dq, Sq, Skv, D,
                causal, scale);
}

template <typename T>
size_t smem_bytes(int which, int D) {
  if (which != 0) return bwd_smem<T>();
  if constexpr (!kFp32<T>) {
    switch (D) {
#define HVD_CASE(DD) \
  case DD:           \
    return HopperFwd<DD>::SMEM;
      HVD_ROWS_FWD_DIMS(HVD_CASE)
#undef HVD_CASE
#define HVD_CASE(DD) \
  case DD:           \
    return WideFwd<DD>::SMEM;
      HVD_WIDE_FWD_DIMS(HVD_CASE)
#undef HVD_CASE
    }
  }
  return D % 128 == 0 ? fwd_smem<T, 128>() : fwd_smem<T, 64>();
}

}  // namespace

// Dispatch on dtype; an unsupported dtype or head dim is
// cudaErrorInvalidValue, which the Python wrapper raises on.
#define HVD_WIDE_DISPATCH(DT_, CALL)                       \
  do {                                                     \
    if (DT_ == kF32) return (int)CALL(float);              \
    if (DT_ == kBF16) return (int)CALL(__nv_bfloat16);     \
    if (DT_ == kF16) return (int)CALL(__half);             \
    return (int)cudaErrorInvalidValue;                     \
  } while (0)

extern "C" {

const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int hvd_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int B, int H, int Sq, int Skv, int D, int dtype,
                  int causal, float scale, void* stream) {
  if (stalled()) return (int)cudaErrorLaunchTimeout;
#define CALL(TT) \
  launch_fwd<TT>(q, k, v, o, lse, B, H, Sq, Skv, D, causal, scale, \
                 (cudaStream_t)stream)
  HVD_WIDE_DISPATCH(dtype, CALL);
#undef CALL
}

int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int B, int H, int Sq, int Skv,
                      int D, int dtype, int causal, float scale,
                      void* stream) {
  if (stalled()) return (int)cudaErrorLaunchTimeout;
#define CALL(TT)                                                          \
  launch_dkv<TT>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Skv, D,     \
                 causal, scale, (cudaStream_t)stream)
  HVD_WIDE_DISPATCH(dtype, CALL);
#undef CALL
}

int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int B, int H, int Sq, int Skv, int D,
                     int dtype, int causal, float scale, void* stream) {
  if (stalled()) return (int)cudaErrorLaunchTimeout;
#define CALL(TT)                                                            \
  launch_dq<TT>(q, k, v, dout, lse, delta, dq, B, H, Sq, Skv, D, causal,    \
                scale, (cudaStream_t)stream)
  HVD_WIDE_DISPATCH(dtype, CALL);
#undef CALL
}

// Dynamic shared memory (bytes) that kernel `which` (0 forward, 1 dK/dV,
// 2 dQ) launches with at head dim D in dtype.
int hvd_flash_smem(int which, int D, int dtype) {
#define CALL(TT) smem_bytes<TT>(which, D)
  HVD_WIDE_DISPATCH(dtype, CALL);
#undef CALL
}

}  // extern "C"
