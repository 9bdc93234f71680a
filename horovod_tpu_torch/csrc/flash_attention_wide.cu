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
// Two designs: Hopper kernels for bf16 and fp16 at the head dims they are
// compiled for, and sliced kernels for the rest.
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
// The bf16/fp16 backward at head dims 192-576 is written for Hopper too:
// wide_dkv_wgmma_kernel, wide_dq_rows_wgmma_kernel and wide_dq_wgmma_kernel
// compute every score product once per (query tile, key tile), where the
// sliced kernels below computed the scores over the whole head dim once
// per output slice (15 to 39 64 x 64 x D products a tile pair against the
// 7 needed). Each is a producer warpgroup (TMA loads in a ring of 2 or 3
// stages, setmaxnreg 24/240, mbar_wait_bounded) and two consumer
// warpgroups, and takes (head, tile) from grouped_tile.
//  - dQ at D = 192 and 256, "rows" (wide_dq_rows_wgmma_kernel, the
//    structure of fwd_wgmma_kernel): 128 query rows a block, Q and dO
//    resident, K and V streamed in three stages; each warpgroup computes S
//    and dP for its 64 rows and holds their whole dQ (D / 2 fp32 a
//    thread), dS as T straight from registers into dQ += dS K_j (K
//    MN-major); the two take turns issuing. 128 rows, not 64, because at
//    these head dims streaming K and V, not the products, set the pace.
//  - dQ above, "columns" (wide_dq_wgmma_kernel): 64 query rows; warpgroup 0
//    issues S, 1 issues dP = dO V^T, and P crosses from 0 to 1 in fp32
//    through shared memory, each thread's values to the thread of the same
//    place (named barriers 1 and 2); 1 forms dS = P (dP - delta) and
//    stores it as T into a double-buffered shared tile (the 32-byte
//    swizzle), from which each warpgroup issues its half of dQ's columns,
//    dQ_c += dS K_j[:, c] (K MN-major in boxes of 64 or 32 columns), with
//    the next tile's scores.
//  - dK/dV (64 keys a block, K and V resident, Q and dO streamed, with
//    each tile's -lse log2(e) and delta staged in shared memory by the
//    producer's TMA warp): the score products split as in dQ's columns
//    layout, P^T crossing from 0 to 1; 0 holds dV and 1 dK, each storing
//    P^T or dS^T
//    as T into its own shared tile for dV += P^T dO_j[:, cols] and dK +=
//    dS^T Q_j[:, cols]. Up to D = 256 a block holds all of dK's and dV's
//    columns (D / 2 fp32 a thread each); above, both whole would pass the
//    register file, so two blocks of a key tile take half each and the
//    scores are computed twice per tile pair.
//  - Tiles (WideDqRows, WideDq, WideDkv; flash_attention.py's
//    WIDE_BWD_TILES): the largest streamed tile (64 to 16 rows) that its
//    stages beside the resident operands leave room for: three in the rows
//    layout; else two, and a third where that tile still fits.
//  - What ptxas needed: no register that a wgmma in flight reads or writes
//    defined by another instruction before the wait, and no code that one
//    consumer warpgroup runs and the other does not around the products
//    that take a register operand: with P^T and dS^T as register A
//    fragments in dK/dV, whose warpgroups run different code, ptxas
//    serialized the wgmma ("WG.AR in divergent path") whatever the loop's
//    shape, so dK/dV and the columns dQ take A from shared tiles.
//
// The other kernels (the fp32 forward and backward, and a 16-bit forward or
// backward above 576) split the OUTPUT's head-dim columns into slices of
// DS (128 where D is a multiple of 128, else 64; dK/dV always 64, since it
// keeps two accumulators) across a third grid dimension. Each block
// computes the scores, and in the backward dP = dO V^T, over the whole
// head dim, streaming Q/K (and dO/V) through shared memory in 64-column
// chunks, and accumulates only its own slice of O, of dK/dV or of dQ.
// Registers hold at most a 64-row x 128-column accumulator, as at D = 128,
// and shared memory holds chunks. The price is recomputing the scores once
// per slice: D / DS times the Q K^T product (and dO V^T), which the bound
// below does not count.
//  - Per tile of the streamed operand the block walks a sequence of items:
//    D / 64 chunk items (64 columns of each operand of the score products)
//    and one slice item (the DS columns of V, of dO and Q, or of K that the
//    output product reads). Items come in by cp.async into a two-stage
//    ring: item i + 1 is in flight while item i is multiplied.
//  - 16-bit types run every product on the tensor cores (mma.sync
//    m16n8k16, the tiles swizzled and read through ldmatrix, P and dS
//    rounded to T straight from the accumulators). fp32 stays fp32 on the
//    FMA pipes (TF32 is too coarse for the fp32 checks) with the same
//    accumulator layout: each thread sums the same (row, column) pairs,
//    from padded fp32 tiles, and P and dS pass through a per-warp shared
//    scratch for their products.
//  - A block is 4 warps, each owning 16 rows of the 64-row tile.
// Every output element of every kernel is written by one block in a fixed
// order, with no atomics, so O, lse, dK/dV and dQ are bit-equal from run to
// run; the fp32 forward's lse is written by the blocks of slice 0. Rows
// that see no key (causal, Sq > Skv) get one convention on every forward
// route (none_rows_kernel, flash_common.cuh). Bounds (the larger of bytes
// at 3.35 TB/s and the products the function needs at 989 TFLOP/s 16-bit,
// 67 TFLOP/s fp32) are computed per shape by chip_smoke.py; at D >= 192
// every one of these kernels is bound by operations.

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

// ============================================== Hopper backward (16-bit) ===
// dK/dV and dQ in bf16 and fp16 at head dims 192-576 (see the top of this
// file). Both kernels are a producer warpgroup and two consumer warpgroups
// that split each tile pair's two score products between them: warpgroup 0
// computes the scores (S, or S^T), warpgroup 1 dP = dO V^T (or dP^T), once
// per tile pair each, and P crosses from 0 to 1 in fp32 through shared
// memory, each thread's values to the thread of the same place in the
// other warpgroup (no bank conflict). Named barriers 1 and 2 order the
// exchange.

constexpr int SMEM_MAX = 232448;  // a block's shared memory on the H100

// Offset (16-byte units) of k-step c (columns [16 c, 16 c + 16)) of a
// K-major wgmma operand of R rows stored as boxes of AB columns (a box row
// is 2 AB bytes, the swizzle).
template <int AB, int R>
__device__ __forceinline__ uint32_t kmajor_step(int c) {
  return ((c / (AB / 16)) * R * 2 * AB + (c % (AB / 16)) * 32) >> 4;
}

// acc (64 x N) = A B^T over D: A (64 of RA rows, boxes of AA columns) and
// B (N rows, boxes of AB columns), both K-major in shared memory.
template <int N, int D, int AA, int AB, typename T, int RA = 64>
__device__ __forceinline__ void issue_abt(float (&acc)[N / 2], uint64_t a,
                                          uint64_t b) {
#pragma unroll
  for (int c = 0; c < D / 16; ++c)
    wgmma_ss<N, T>(acc, a + kmajor_step<AA, RA>(c), b + kmajor_step<AB, N>(c),
                   c != 0);
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// A stage of either backward kernel is read twice: by its tile's scores
// and, one tile later, by its tile's output product, so a ring of two
// leaves the next load little time ahead of its use. Each kernel takes the
// largest tile that two stages beside its resident operands leave room
// for, and a third stage where that tile still fits with it.

// Shared memory of the dQ kernel at head dim D with key tiles of hn and ns
// stages: Q and dO resident, the K and V stages, P (fp32), two dS tiles,
// barriers, and room to align the base to 1024 bytes.
constexpr int wide_dq_bytes(int D, int hn, int ns) {
  return 2 * 64 * D * 2 + 2 * ns * hn * D * 2 + 64 * hn * 4 +
         2 * 64 * hn * 2 + 8 * (1 + 4 * ns) + 1024;
}

// Shared memory of the dK/dV kernel at head dim D with query tiles of bm
// and ns stages: K and V resident, the Q and dO stages with their rows'
// -lse log2(e) and delta (fp32), P^T (fp32), each warpgroup's A tile (P^T
// or dS^T as T), barriers, and room to align the base to 1024 bytes.
constexpr int wide_dkv_bytes(int D, int bm, int ns) {
  return 2 * 64 * D * 2 + ns * (2 * bm * D * 2 + 2 * bm * 4) + 64 * bm * 4 +
         2 * 64 * bm * 2 + 8 * (1 + 2 * ns) + 1024;
}

// (tile rows, stages) of kernel `dkv` at head dim D, as 8 rows + stages.
constexpr bool wide_bwd_fits(int D, bool dkv, int rows, int ns) {
  return (dkv ? wide_dkv_bytes(D, rows, ns) : wide_dq_bytes(D, rows, ns)) <=
         SMEM_MAX;
}
constexpr int wide_bwd_tile(int D, bool dkv) {
  for (int rows = 64; rows >= 16; rows -= 16)
    if (wide_bwd_fits(D, dkv, rows, 2))
      return rows * 8 + (wide_bwd_fits(D, dkv, rows, 3) ? 3 : 2);
  return 0;
}

// dQ at D = 320-576 ("columns"): 64 query rows a block; HN keys a K/V
// tile and NS stages (wide_bwd_tile). Warpgroup c owns dQ's columns
// [c W, (c + 1) W), issued as one wgmma of N1 columns or two (N1 + N2)
// past wgmma's 256. K comes in boxes of AK columns, so that each
// warpgroup's columns, and the second instruction's, start on one.
template <int D>
struct WideDq {
  static constexpr int THREADS = 384;
  static constexpr int NS = wide_bwd_tile(D, false) % 8;
  static constexpr int W = D / 2;
  static constexpr int N1 = W <= 256 ? W : 160;
  static constexpr int N2 = W - N1;
  static constexpr int AK = W % 64 == 0 ? 64 : 32;
  static constexpr int SWK = 2 * AK;
  static constexpr int HN = wide_bwd_tile(D, false) / 8;
  static constexpr int QO_BYTES = 64 * D * 2;
  static constexpr int KV_BYTES = HN * D * 2;
  static constexpr int P_BYTES = 64 * HN * 4;
  static constexpr int DS_BYTES = 64 * HN * 2;
  static constexpr int SMEM = wide_dq_bytes(D, HN, NS);
  static_assert(D % 64 == 0 && D >= 320 && D <= 576, "a wide head dim");
  static_assert(W % AK == 0 && N1 % AK == 0 && N2 <= 256, "dQ's columns");
  static_assert(SMEM <= SMEM_MAX, "fits a block's shared memory");
};

// Replaces _bwd_dq_kernel (pallas_attention.py:174) for bf16 and fp16 at
// D = 320-576. Per key tile j (TMA, NS stages of K and V; Q and dO
// resident): warpgroup 0 issues S = Q K_j^T and warpgroup 1 dP = dO V_j^T
// (each with its column half of the last tile's dQ += dS K), then 0 stores
// P = exp(scale S - lse) (zero where an edge hides the key) for 1, which
// stores dS = P (dP - delta) as T into a double-buffered shared tile (the
// 32-byte swizzle, as the forward's P); both then take dS from it for
// dQ_c += dS K_j[:, c-half] (K MN-major). dQ is scaled once at the end.
template <int D, typename T>
__global__ void __launch_bounds__(WideDq<D>::THREADS, 1)
    wide_dq_wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                         __grid_constant__ const CUtensorMap tdo,
                         __grid_constant__ const CUtensorMap tk,
                         __grid_constant__ const CUtensorMap tv,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dq,
                         int Sq, int Skv, int causal, float scale) {
  using L = WideDq<D>;
  constexpr int NS = L::NS, HN = L::HN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  T* Qs = reinterpret_cast<T*>(base);
  T* dOs = reinterpret_cast<T*>(base + L::QO_BYTES);
  T* Ks = reinterpret_cast<T*>(base + 2 * L::QO_BYTES);  // NS stages
  T* Vs = reinterpret_cast<T*>(base + 2 * L::QO_BYTES + NS * L::KV_BYTES);
  float* Px = reinterpret_cast<float*>(base + 2 * L::QO_BYTES +
                                       2 * NS * L::KV_BYTES);
  unsigned char* dSs = reinterpret_cast<unsigned char*>(Px) + L::P_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(dSs + 2 * L::DS_BYTES);
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
      // K: lane 0 of each consumer warp after its dQ product; V: warpgroup
      // 1's after dP.
      mbar_init(k_empty + s, 8);
      mbar_init(v_empty + s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, 2 * L::QO_BYTES);
      for (int b = 0; b < D / 64; ++b) {
        tma_load(Qs + b * 64 * 64, &tq, q_full, b * 64, q_start, bh);
        tma_load(dOs + b * 64 * 64, &tdo, q_full, b * 64, q_start, bh);
      }
      for (int j = 0; j < nkb; ++j) {
        const int st = j % NS, ph = (j / NS) & 1;
        if (j >= NS) mbar_wait_bounded(k_empty + st, ph ^ 1);
        mbar_expect_tx(k_full + st, L::KV_BYTES);
        for (int b = 0; b < D / L::AK; ++b)
          tma_load(Ks + st * HN * D + b * HN * L::AK, &tk, k_full + st,
                   b * L::AK, j * HN, bh);
        if (j >= NS) mbar_wait_bounded(v_empty + st, ph ^ 1);
        mbar_expect_tx(v_full + st, L::KV_BYTES);
        for (int b = 0; b < D / 64; ++b)
          tma_load(Vs + st * HN * D + b * HN * 64, &tv, v_full + st, b * 64,
                   j * HN, bh);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int rl0 = warp * 16 + (lane >> 2);  // this thread's rows: +0, +8
  const int row0 = q_start + rl0;
  const float sl2 = scale * LOG2E;
  // Warpgroup 0 needs -lse log2(e) of its rows, 1 delta. Rows past Sq give
  // P = 0.
  float rv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const size_t at_ = (size_t)bh * Sq + row;
    rv[r] = row >= Sq ? (wg == 0 ? -INFINITY : 0.f)
            : wg == 0 ? -lse[at_] * LOG2E
                      : delta[at_];
  }
  const uint64_t a_desc =
      gmma_desc(smem_u32(wg == 0 ? Qs : dOs), 16, 8 * 128, 128);
  const uint64_t k_desc = gmma_desc(smem_u32(Ks), 16, 8 * L::SWK, L::SWK);
  const uint64_t v_desc = gmma_desc(smem_u32(Vs), 16, 8 * 128, 128);
  const uint64_t ds_desc = gmma_desc(smem_u32(dSs), 16, 8 * 32, 32);
  const uint64_t kmn_desc =
      gmma_desc(smem_u32(Ks) + (wg * L::W / L::AK) * HN * L::SWK,
                HN * L::SWK, 8 * L::SWK, L::SWK);
  constexpr int KV_STEP = L::KV_BYTES >> 4;  // a stage, in 16 bytes
  constexpr int DS_STEP = L::DS_BYTES >> 4;
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  float s[HN / 2], o1[L::N1 / 2], o2[L::N2 > 0 ? L::N2 / 2 : 1];
#pragma unroll
  for (int i = 0; i < L::N1 / 2; ++i) o1[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (L::N2 > 0 ? L::N2 / 2 : 1); ++i) o2[i] = 0.f;
  // dQ_c += dS_j K_j[:, c-half]: HN / 16 k-steps of 16 keys.
  auto dq_issue = [&](int j) {
    const uint64_t a = ds_desc + (j & 1) * DS_STEP;
    const uint64_t b = kmn_desc + (j % NS) * KV_STEP;
#pragma unroll
    for (int kk = 0; kk < HN / 16; ++kk) {
      wgmma_ss_t<L::N1, T>(o1, a + ((kk * 2048) >> 4),
                           b + ((kk * 16 * L::SWK) >> 4), 1);
      if constexpr (L::N2 > 0)
        wgmma_ss_t<L::N2, T>(
            o2, a + ((kk * 2048) >> 4),
            b + ((L::N1 / L::AK * HN * L::SWK + kk * 16 * L::SWK) >> 4), 1);
    }
  };

  mbar_wait_bounded(q_full, 0);
  for (int j = 0; j < nkb; ++j) {
    const int st = j % NS, ph = (j / NS) & 1;
    const int k0 = j * HN;
    const bool edge =
        k0 + HN > Skv || (causal && k0 + HN - 1 > q_start + (Skv - Sq));
    if (wg == 0) {
      mbar_wait_bounded(k_full + st, ph);
      wgmma_fence();
      issue_abt<HN, D, 64, L::AK, T>(s, a_desc, k_desc + st * KV_STEP);
    } else {
      // K_j too: this warpgroup reads it in its dQ product of tile j.
      mbar_wait_bounded(k_full + st, ph);
      mbar_wait_bounded(v_full + st, ph);
      wgmma_fence();
      issue_abt<HN, D, 64, 64, T>(s, a_desc, v_desc + st * KV_STEP);
    }
    wgmma_commit();
    if (j > 0) {
      dq_issue(j - 1);
      wgmma_commit();
      wgmma_wait<1>();  // the scores of tile j; dQ of tile j - 1 may run
    } else {
      wgmma_wait<0>();
    }
    pin(s);
    if (wg == 0) {
      // P in base 2, one FMA and one ex2 a score; scores are only read.
#pragma unroll
      for (int i = 0; i < HN / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(fmaf(s[4 * i + e], sl2, rv[e >> 1]));
          if (edge && !visible(row0 + (e >> 1) * 8,
                               k0 + i * 8 + 2 * t + (e & 1), Sq, Skv, causal))
            p = 0.f;
          Px[(4 * i + e) * 128 + tid] = p;
        }
      named_arrive(1);
    } else {
      release(v_empty + st);
      named_sync(1);  // P of tile j is stored
      // dS as T into tile j & 1: blocks of 16 keys, 64 rows of 32 bytes,
      // the 32-byte swizzle (a row's 16-byte half flips every 4 rows).
      unsigned char* dt = dSs + (j & 1) * L::DS_BYTES;
#pragma unroll
      for (int i = 0; i < HN / 8; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 4 * i + 2 * r;
          const float d0 = Px[e * 128 + tid] * (s[e] - rv[r]);
          const float d1 = Px[(e + 1) * 128 + tid] * (s[e + 1] - rv[r]);
          const int key = i * 8 + 2 * t, row = rl0 + 8 * r;
          *reinterpret_cast<uint32_t*>(
              dt + (key >> 4) * 2048 + row * 32 +
              ((((key >> 3) ^ (row >> 2)) & 1) << 4) + (key & 7) * 2) =
              pack16<T>(d0, d1);
        }
      // The tile's stores reach wgmma's reads (the async proxy).
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    if (j > 0) {
      wgmma_wait<0>();
      pin(o1);
      pin(o2);
      release(k_empty + (j - 1) % NS);
    }
    named_sync(2);  // dS of tile j is stored; P may be overwritten
  }
  if (nkb > 0) {
    wgmma_fence();
    dq_issue(nkb - 1);
    wgmma_commit();
    wgmma_wait<0>();
    pin(o1);
    pin(o2);
    release(k_empty + (nkb - 1) % NS);
  }

  T* dqp = dq + (size_t)bh * Sq * D + wg * L::W;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    T* drow = dqp + (size_t)row * D + 2 * t;
#pragma unroll
    for (int i = 0; i < L::N1 / 8; ++i)
      *reinterpret_cast<uint32_t*>(drow + i * 8) = pack16<T>(
          o1[4 * i + 2 * r] * scale, o1[4 * i + 2 * r + 1] * scale);
    if constexpr (L::N2 > 0) {
#pragma unroll
      for (int i = 0; i < L::N2 / 8; ++i)
        *reinterpret_cast<uint32_t*>(drow + L::N1 + i * 8) = pack16<T>(
            o2[4 * i + 2 * r] * scale, o2[4 * i + 2 * r + 1] * scale);
    }
  }
}

// dK/dV: 64 keys a block; BM query rows a Q/dO tile and NS stages
// (wide_bwd_tile). Warpgroup 0 holds dV, 1 dK, each
// for NSPLIT-th of the columns: all of them up to D = 256 (D / 2 fp32 a
// thread), half above, where both whole would pass the register file (2 x
// 64 x D fp32 is 256 KB at D = 512), so the grid's NSPLIT blocks of a key
// tile each compute its scores once: twice per tile pair, not D / 64
// times. The output products take Q and dO MN-major from boxes of AB
// columns, so that the block's columns, and the second instruction's,
// start on one.
template <int D>
struct WideDkv {
  static constexpr int THREADS = 384;
  static constexpr int NS = wide_bwd_tile(D, true) % 8;
  static constexpr int NSPLIT = D <= 256 ? 1 : 2;
  static constexpr int W = D / NSPLIT;
  static constexpr int N1 = W <= 256 ? W : 160;
  static constexpr int N2 = W - N1;
  static constexpr int AB = W % 64 == 0 ? 64 : 32;
  static constexpr int SWB = 2 * AB;
  static constexpr int BM = wide_bwd_tile(D, true) / 8;
  static constexpr int KV_BYTES = 64 * D * 2;
  static constexpr int QO_BYTES = BM * D * 2;
  static constexpr int P_BYTES = 64 * BM * 4;
  static constexpr int A_BYTES = 64 * BM * 2;
  static constexpr int SMEM = wide_dkv_bytes(D, BM, NS);
  static_assert(D % 64 == 0 && D >= 192 && D <= 576, "a wide head dim");
  static_assert(W % AB == 0 && N1 % AB == 0 && N2 <= 256, "dK/dV columns");
  static_assert(SMEM <= SMEM_MAX, "fits a block's shared memory");
};

// Replaces _bwd_dkv_kernel (pallas_attention.py:114) for bf16 and fp16 at
// D = 192-576. Per query tile j (TMA, NS stages of Q and dO; K and V
// resident): warpgroup 0 issues S^T = K Q_j^T and warpgroup 1 dP^T =
// V dO_j^T (each with the last tile's output product), then 0 turns S^T
// into P^T = exp(scale S^T - lse) (zero where an edge hides the pair) and
// stores it for 1, which forms dS^T = P^T (dP^T - delta) (the producer's
// TMA warp stages each tile's -lse log2(e) and delta in shared memory
// beside Q and dO: read from device memory by the consumers, they held up
// every tile); each stores its
// matrix as T into its own shared tile (the 32-byte swizzle, as dQ's dS)
// and issues its product from there with the next tile's scores: dV +=
// P^T dO_j[:, cols] (warpgroup 0) and dK += dS^T Q_j[:, cols] (1), dO and
// Q MN-major. (With P^T and dS^T as register operands ptxas serialized the
// wgmma.) dK is scaled once at the end.
template <int D, typename T>
__global__ void __launch_bounds__(WideDkv<D>::THREADS, 1)
    wide_dkv_wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                          __grid_constant__ const CUtensorMap tdo,
                          __grid_constant__ const CUtensorMap tk,
                          __grid_constant__ const CUtensorMap tv,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int Sq,
                          int Skv, int causal, float scale) {
  using L = WideDkv<D>;
  constexpr int NS = L::NS, BM = L::BM;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  T* Ks = reinterpret_cast<T*>(base);
  T* Vs = reinterpret_cast<T*>(base + L::KV_BYTES);
  T* Qs = reinterpret_cast<T*>(base + 2 * L::KV_BYTES);  // NS stages
  T* dOs = reinterpret_cast<T*>(base + 2 * L::KV_BYTES + NS * L::QO_BYTES);
  float* Px = reinterpret_cast<float*>(base + 2 * L::KV_BYTES +
                                       2 * NS * L::QO_BYTES);
  unsigned char* As =  // 2 tiles, one a warpgroup
      reinterpret_cast<unsigned char*>(Px) + L::P_BYTES;
  // NS stages of (-lse log2(e), delta) for BM query rows each.
  float* Rs = reinterpret_cast<float*>(As + 2 * L::A_BYTES);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(Rs + NS * 2 * BM);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + NS;

  // (head, key tile, column part); key tiles first to last, so that under
  // the causal mask the tiles with the most query tiles start first.
  const int nkt = (Skv + 63) / 64;
  int bh, x;
  grouped_tile(nkt * L::NSPLIT, Sq, D, bh, x);
  const int tile = nkt * L::NSPLIT - 1 - x;
  const int k_start = tile / L::NSPLIT * 64;
  const int col0 = tile % L::NSPLIT * L::W;
  const int off = Skv - Sq;
  const int nqb = (Sq + BM - 1) / BM;
  // Query rows r with r + (Skv - Sq) >= k_start see this key tile.
  const int qb0 = causal ? (k_start - off > 0 ? k_start - off : 0) / BM : 0;
  const int n = nqb > qb0 ? nqb - qb0 : 0;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x < 288) {
      // Warp 0: lane 0 keeps the TMA loads in flight; every lane first
      // stores its share of each tile's -lse log2(e) and delta (rows past
      // Sq give P = 0), read one tile ahead, so that lane 0's arrival
      // publishes them with the tile.
      constexpr int PER = (BM + 31) / 32;  // rows a lane
      const int lane = threadIdx.x & 31;
      const float* lp = lse + (size_t)bh * Sq;
      const float* dp = delta + (size_t)bh * Sq;
      float na[PER], nd[PER];  // the next tile's
      auto rows = [&](int j) {
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          const int row = (qb0 + j) * BM + lane + 32 * k;
          na[k] = row < Sq ? -lp[row] * LOG2E : -INFINITY;
          nd[k] = row < Sq ? dp[row] : 0.f;
        }
      };
      if (n > 0) rows(0);
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * L::KV_BYTES);
        for (int b = 0; b < D / 64; ++b) {
          tma_load(Ks + b * 64 * 64, &tk, kv_full, b * 64, k_start, bh);
          tma_load(Vs + b * 64 * 64, &tv, kv_full, b * 64, k_start, bh);
        }
      }
      for (int j = 0; j < n; ++j) {
        const int st = j % NS, ph = (j / NS) & 1;
        const int q0 = (qb0 + j) * BM;
        float a[PER], d[PER];
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          a[k] = na[k];
          d[k] = nd[k];
        }
        if (j + 1 < n) rows(j + 1);
        if (j >= NS) mbar_wait_bounded(empty + st, ph ^ 1);
        float* r = Rs + st * 2 * BM;
#pragma unroll
        for (int k = 0; k < PER; ++k)
          if (lane + 32 * k < BM) {
            r[lane + 32 * k] = a[k];
            r[BM + lane + 32 * k] = d[k];
          }
        __syncwarp();
        if (lane == 0) {
          mbar_expect_tx(full + st, 2 * L::QO_BYTES);
          for (int b = 0; b < D / L::AB; ++b) {
            tma_load(Qs + st * BM * D + b * BM * L::AB, &tq, full + st,
                     b * L::AB, q0, bh);
            tma_load(dOs + st * BM * D + b * BM * L::AB, &tdo, full + st,
                     b * L::AB, q0, bh);
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int key0 = k_start + warp * 16 + (lane >> 2);  // keys +0, +8
  const float sl2 = scale * LOG2E;
  // S^T from K and Q (warpgroup 0), dP^T from V and dO (1), all K-major;
  // the output product's B, dO (0) or Q (1), MN-major from column col0.
  const uint64_t a_desc =
      gmma_desc(smem_u32(wg == 0 ? Ks : Vs), 16, 8 * 128, 128);
  const uint64_t b_desc =
      gmma_desc(smem_u32(wg == 0 ? Qs : dOs), 16, 8 * L::SWB, L::SWB);
  const uint64_t mn_desc =
      gmma_desc(smem_u32(wg == 0 ? dOs : Qs) + col0 / L::AB * BM * L::SWB,
                BM * L::SWB, 8 * L::SWB, L::SWB);
  unsigned char* at = As + wg * L::A_BYTES;  // this warpgroup's A tile
  const uint64_t at_desc = gmma_desc(smem_u32(at), 16, 8 * 32, 32);
  constexpr int QO_STEP = L::QO_BYTES >> 4;  // a stage, in 16 bytes
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  float s[BM / 2], a1[L::N1 / 2], a2[L::N2 > 0 ? L::N2 / 2 : 1];
#pragma unroll
  for (int i = 0; i < L::N1 / 2; ++i) a1[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (L::N2 > 0 ? L::N2 / 2 : 1); ++i) a2[i] = 0.f;
  // dV (or dK) += A B_j[:, cols], A from this warpgroup's tile: BM / 16
  // k-steps of 16 query rows.
  auto out_issue = [&](int j) {
    const uint64_t b = mn_desc + (j % NS) * QO_STEP;
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      wgmma_ss_t<L::N1, T>(a1, at_desc + ((kk * 2048) >> 4),
                           b + ((kk * 16 * L::SWB) >> 4), 1);
      if constexpr (L::N2 > 0)
        wgmma_ss_t<L::N2, T>(
            a2, at_desc + ((kk * 2048) >> 4),
            b + ((L::N1 / L::AB * BM * L::SWB + kk * 16 * L::SWB) >> 4), 1);
    }
  };

  mbar_wait_bounded(kv_full, 0);
  for (int j = 0; j < n; ++j) {
    const int st = j % NS, ph = (j / NS) & 1;
    const int q0 = (qb0 + j) * BM;
    const bool edge = q0 + BM > Sq || k_start + 64 > Skv ||
                      (causal && k_start + 63 > q0 + off);
    mbar_wait_bounded(full + st, ph);
    // This thread's query columns q0 + 8 i + 2 t + c: -lse log2(e)
    // (warpgroup 0) or delta (1).
    const float* rs = Rs + st * 2 * BM + wg * BM;
    float cv[BM / 4];
#pragma unroll
    for (int i = 0; i < BM / 8; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) cv[2 * i + c] = rs[8 * i + 2 * t + c];
    wgmma_fence();
    issue_abt<BM, D, 64, L::AB, T>(s, a_desc, b_desc + st * QO_STEP);
    wgmma_commit();
    if (j > 0) {
      out_issue(j - 1);
      wgmma_commit();
      wgmma_wait<1>();  // the scores of tile j; the last product may run
    } else {
      wgmma_wait<0>();
    }
    pin(s);
    // P^T (warpgroup 0) or dS^T (1) as T, in pairs: pair (kk, i) is score
    // 8 kk + 2 i and the next, key row +8 (i & 1), query columns
    // 8 (2 kk + i / 2) + 2 t and the next. The accumulators are only read.
    uint32_t pn[BM / 16][4];
    if (wg == 0) {
      if (j > 0) named_sync(2);  // warpgroup 1 has read the last P^T
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = 8 * kk + 2 * i, c = 2 * (2 * kk + i / 2);
          float p0 = ex2(fmaf(s[e], sl2, cv[c]));
          float p1 = ex2(fmaf(s[e + 1], sl2, cv[c + 1]));
          if (edge) {
            const int col = q0 + 4 * c + 2 * t, key = key0 + 8 * (i & 1);
            if (!visible(col, key, Sq, Skv, causal)) p0 = 0.f;
            if (!visible(col + 1, key, Sq, Skv, causal)) p1 = 0.f;
          }
          Px[e * 128 + tid] = p0;
          Px[(e + 1) * 128 + tid] = p1;
          pn[kk][i] = pack16<T>(p0, p1);
        }
      named_arrive(1);
    } else {
      named_sync(1);  // P^T of tile j is stored
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = 8 * kk + 2 * i, c = 2 * (2 * kk + i / 2);
          pn[kk][i] =
              pack16<T>(Px[e * 128 + tid] * (s[e] - cv[c]),
                        Px[(e + 1) * 128 + tid] * (s[e + 1] - cv[c + 1]));
        }
      named_arrive(2);
    }
    if (j > 0) {
      wgmma_wait<0>();
      pin(a1);
      pin(a2);
      release(empty + (j - 1) % NS);
    }
    // Into the A tile, once the product that read it is done: blocks of 16
    // query rows, 64 key rows of 32 bytes, the 32-byte swizzle.
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = 8 * (2 * kk + i / 2) + 2 * t;
        const int row = warp * 16 + (lane >> 2) + 8 * (i & 1);
        *reinterpret_cast<uint32_t*>(
            at + (q >> 4) * 2048 + row * 32 +
            ((((q >> 3) ^ (row >> 2)) & 1) << 4) + (q & 7) * 2) = pn[kk][i];
      }
    // The stores reach wgmma's reads (the async proxy), from all 4 warps.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
  }
  if (n > 0) {
    wgmma_fence();
    out_issue(n - 1);
    wgmma_commit();
    wgmma_wait<0>();
    pin(a1);
    pin(a2);
    release(empty + (n - 1) % NS);
    if (wg == 0) named_sync(2);  // warpgroup 1's last arrival
  }

  T* outp = (wg == 0 ? dv : dk) + (size_t)bh * Skv * D + col0;
  const float mul = wg == 0 ? 1.f : scale;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= Skv) continue;
    T* orow = outp + (size_t)key * D + 2 * t;
#pragma unroll
    for (int i = 0; i < L::N1 / 8; ++i)
      *reinterpret_cast<uint32_t*>(orow + i * 8) = pack16<T>(
          a1[4 * i + 2 * r] * mul, a1[4 * i + 2 * r + 1] * mul);
    if constexpr (L::N2 > 0) {
#pragma unroll
      for (int i = 0; i < L::N2 / 8; ++i)
        *reinterpret_cast<uint32_t*>(orow + L::N1 + i * 8) = pack16<T>(
            a2[4 * i + 2 * r] * mul, a2[4 * i + 2 * r + 1] * mul);
    }
  }
}

// dQ "rows" at D = 192 and 256: 128 query rows a block, each consumer
// warpgroup 64 of them with their whole dQ (D / 2 fp32 a thread), so K and
// V are streamed once per 128 query rows, not per 64 (at these head dims
// the 64-row layout above is bound by that stream, not by its products).
// Each warpgroup computes both S and dP for its rows: no exchange. Three
// stages of K and V beside Q and dO for 128 rows, with the largest key
// tile HN that leaves room for them (tools/flash_bwd_variants.py times two
// stages of the next larger tile).
constexpr int wide_dq_rows_bytes(int D, int hn, int ns) {
  return 2 * 128 * D * 2 + 2 * ns * hn * D * 2 + 8 * (1 + 4 * ns) + 1024;
}
constexpr int wide_dq_rows_tile(int D, int ns) {
  for (int hn = 64; hn >= 16; hn -= 16)
    if (wide_dq_rows_bytes(D, hn, ns) <= SMEM_MAX) return hn * 8 + ns;
  return 0;
}
constexpr int WIDE_DQ_ROWS_STAGES = 3;

template <int D>
struct WideDqRows {
  static constexpr int THREADS = 384;
  static constexpr int HM = 128;
  static constexpr int HN = wide_dq_rows_tile(D, WIDE_DQ_ROWS_STAGES) / 8;
  static constexpr int NS = WIDE_DQ_ROWS_STAGES;
  static constexpr int NBOX = D / 64;  // boxes of 64 columns, 128-byte swizzle
  static constexpr int QO_BYTES = HM * D * 2;
  static constexpr int KV_BYTES = HN * D * 2;
  static constexpr int SMEM = wide_dq_rows_bytes(D, HN, NS);
  static_assert(D == 192 || D == 256, "the rows layout's head dims");
  static_assert(HN % 16 == 0 && SMEM <= SMEM_MAX, "a tile that fits");
};

// Replaces _bwd_dq_kernel (pallas_attention.py:174) for bf16 and fp16 at
// D = 192 and 256, with fwd_wgmma_kernel's structure (hopper_fwd.cuh): per
// key tile j each warpgroup issues S = Q_w K_j^T and dP = dO_w V_j^T
// (TMA, NS stages of K and V) with its last tile's dQ_w += dS K_{j-1}
// (dS as T straight from registers, K MN-major), forms P = exp(scale S -
// lse) (zero where an edge hides the key) and dS = P (dP - delta) while
// that product runs, and the two take turns issuing (named barriers 1
// and 2). dQ is scaled once at the end.
template <int D, typename T>
__global__ void __launch_bounds__(WideDqRows<D>::THREADS, 1)
    wide_dq_rows_wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                        __grid_constant__ const CUtensorMap tdo,
                        __grid_constant__ const CUtensorMap tk,
                        __grid_constant__ const CUtensorMap tv,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int Sq, int Skv, int causal, float scale) {
  using L = WideDqRows<D>;
  constexpr int NS = L::NS, HN = L::HN, HM = L::HM;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  T* Qs = reinterpret_cast<T*>(base);
  T* dOs = reinterpret_cast<T*>(base + L::QO_BYTES);
  T* Ks = reinterpret_cast<T*>(base + 2 * L::QO_BYTES);  // NS stages
  T* Vs = reinterpret_cast<T*>(base + 2 * L::QO_BYTES + NS * L::KV_BYTES);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(
      base + 2 * L::QO_BYTES + 2 * NS * L::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + NS;
  uint64_t* k_empty = v_full + NS;
  uint64_t* v_empty = k_empty + NS;

  int bh, qt;
  grouped_tile((Sq + HM - 1) / HM, Skv, D, bh, qt);
  const int q_start = qt * HM;
  const int nkb = key_tiles(q_start, Sq, Skv, causal, HM, HN);
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      // Released by lane 0 of each consumer warp: V after dP, K after the
      // dQ product.
      mbar_init(k_empty + s, 8);
      mbar_init(v_empty + s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, 2 * L::QO_BYTES);
      for (int b = 0; b < L::NBOX; ++b) {
        tma_load(Qs + b * HM * 64, &tq, q_full, b * 64, q_start, bh);
        tma_load(dOs + b * HM * 64, &tdo, q_full, b * 64, q_start, bh);
      }
      for (int j = 0; j < nkb; ++j) {
        const int st = j % NS, ph = (j / NS) & 1;
        if (j >= NS) mbar_wait_bounded(k_empty + st, ph ^ 1);
        mbar_expect_tx(k_full + st, L::KV_BYTES);
        for (int b = 0; b < L::NBOX; ++b)
          tma_load(Ks + st * HN * D + b * HN * 64, &tk, k_full + st, b * 64,
                   j * HN, bh);
        if (j >= NS) mbar_wait_bounded(v_empty + st, ph ^ 1);
        mbar_expect_tx(v_full + st, L::KV_BYTES);
        for (int b = 0; b < L::NBOX; ++b)
          tma_load(Vs + st * HN * D + b * HN * 64, &tv, v_full + st, b * 64,
                   j * HN, bh);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows [q_start + 64 wg, + 64).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int q0 = q_start + wg * 64;
  const int row0 = q0 + warp * 16 + (lane >> 2);  // rows +0, +8
  const float sl2 = scale * LOG2E;
  // -lse log2(e) and delta of this thread's rows; rows past Sq give P = 0.
  float nl2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    nl2[r] = row < Sq ? -lse[(size_t)bh * Sq + row] * LOG2E : -INFINITY;
    dl[r] = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;
  }
  const uint64_t q_desc =
      gmma_desc(smem_u32(Qs) + wg * 64 * 128, 16, 8 * 128, 128);
  const uint64_t do_desc =
      gmma_desc(smem_u32(dOs) + wg * 64 * 128, 16, 8 * 128, 128);
  const uint64_t k_desc = gmma_desc(smem_u32(Ks), 16, 8 * 128, 128);
  const uint64_t v_desc = gmma_desc(smem_u32(Vs), 16, 8 * 128, 128);
  const uint64_t kmn_desc = gmma_desc(smem_u32(Ks), HN * 128, 8 * 128, 128);
  constexpr int KV_STEP = L::KV_BYTES >> 4;  // a stage, in 16 bytes
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  if (wg == 1) turn_pass(wg);

  float s[HN / 2], dp[HN / 2], acc[D / 2];
  uint32_t pk[HN / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // dS of tile j in fp32, in place of dP (whose product is done), as
  // fwd_wgmma_kernel's softmax writes P over S: a register that a wgmma in
  // flight reads (pk) must not be written before its wait.
  auto dscores = [&](int j) {
    const int k0 = j * HN;
    const bool edge =
        k0 + HN > Skv || (causal && k0 + HN - 1 > q0 + (Skv - Sq));
#pragma unroll
    for (int i = 0; i < HN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(s[4 * i + e], sl2, nl2[e >> 1]));
        if (edge && !visible(row0 + 8 * (e >> 1), k0 + 8 * i + 2 * t + (e & 1),
                             Sq, Skv, causal))
          p = 0.f;
        dp[4 * i + e] = p * (dp[4 * i + e] - dl[e >> 1]);
      }
  };
  // dQ_w += dS K_j: HN / 16 k-steps of 16 keys.
  auto dq_issue = [&](int j) {
    const uint64_t b = kmn_desc + (j % NS) * KV_STEP;
#pragma unroll
    for (int kk = 0; kk < HN / 16; ++kk)
      wgmma_rs<D, T>(acc, pk[kk], b + ((kk * 16 * 128) >> 4), 1);
  };

  mbar_wait_bounded(q_full, 0);
  if (nkb > 0) {
    mbar_wait_bounded(k_full, 0);
    mbar_wait_bounded(v_full, 0);
    turn_wait(wg);
    wgmma_fence();
    issue_abt<HN, D, 64, 64, T, HM>(s, q_desc, k_desc);
    issue_abt<HN, D, 64, 64, T, HM>(dp, do_desc, v_desc);
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<0>();
    pin(s);
    pin(dp);
    release(v_empty);
    dscores(0);
    pack_p<T, HN>(pk, dp);
  }
  for (int j = 1; j < nkb; ++j) {
    const int st = j % NS, sp = (j - 1) % NS;
    mbar_wait_bounded(k_full + st, (j / NS) & 1);
    mbar_wait_bounded(v_full + st, (j / NS) & 1);
    turn_wait(wg);
    wgmma_fence();
    issue_abt<HN, D, 64, 64, T, HM>(s, q_desc, k_desc + st * KV_STEP);
    issue_abt<HN, D, 64, 64, T, HM>(dp, do_desc, v_desc + st * KV_STEP);
    wgmma_commit();
    dq_issue(j - 1);
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<1>();  // the scores of tile j; dQ of tile j - 1 may run
    pin(s);
    pin(dp);
    release(v_empty + st);
    dscores(j);
    wgmma_wait<0>();
    pin(acc);
    pin(dp);  // pk is rewritten only after the product that reads it
    release(k_empty + sp);
    pack_p<T, HN>(pk, dp);
  }
  if (nkb > 0) {
    turn_wait(wg);
    wgmma_fence();
    dq_issue(nkb - 1);
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<0>();
    pin(acc);
    release(k_empty + (nkb - 1) % NS);
  }

  T* dqp = dq + (size_t)bh * Sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(dqp + (size_t)row * D + i * 8 + 2 * t) =
          pack16<T>(acc[4 * i + 2 * r] * scale,
                    acc[4 * i + 2 * r + 1] * scale);
  }
  if (wg == 0) turn_wait(wg);  // warpgroup 1's last pass
}

template <int D, typename T>
cudaError_t launch_wide_dq_rows(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int B, int H,
                                int Sq, int Skv, int causal, float scale,
                                cudaStream_t st) {
  using L = WideDqRows<D>;
  CUtensorMap tq, tdo, tk, tv;
  if (!tensor_map<T>(&tq, q, D, Sq, B * H, 64, L::HM, 128) ||
      !tensor_map<T>(&tdo, dout, D, Sq, B * H, 64, L::HM, 128) ||
      !tensor_map<T>(&tk, k, D, Skv, B * H, 64, L::HN, 128) ||
      !tensor_map<T>(&tv, v, D, Skv, B * H, 64, L::HN, 128))
    return cudaErrorInvalidValue;
  return launch(wide_dq_rows_wgmma_kernel<D, T>,
                dim3(B * H * ((Sq + L::HM - 1) / L::HM)), L::THREADS, L::SMEM,
                st, tq, tdo, tk, tv, (const float*)lse, (const float*)delta,
                (T*)dq, Sq, Skv, causal, scale);
}

template <int D, typename T>
cudaError_t launch_wide_dq_wgmma(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int B, int H,
                                 int Sq, int Skv, int causal, float scale,
                                 cudaStream_t st) {
  using L = WideDq<D>;
  CUtensorMap tq, tdo, tk, tv;
  if (!tensor_map<T>(&tq, q, D, Sq, B * H, 64, 64, 128) ||
      !tensor_map<T>(&tdo, dout, D, Sq, B * H, 64, 64, 128) ||
      !tensor_map<T>(&tk, k, D, Skv, B * H, L::AK, L::HN, L::SWK) ||
      !tensor_map<T>(&tv, v, D, Skv, B * H, 64, L::HN, 128))
    return cudaErrorInvalidValue;
  return launch(wide_dq_wgmma_kernel<D, T>, dim3(B * H * ((Sq + 63) / 64)),
                L::THREADS, L::SMEM, st, tq, tdo, tk, tv, (const float*)lse,
                (const float*)delta, (T*)dq, Sq, Skv, causal, scale);
}

template <int D, typename T>
cudaError_t launch_wide_dkv_wgmma(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, int B, int H, int Sq,
                                  int Skv, int causal, float scale,
                                  cudaStream_t st) {
  using L = WideDkv<D>;
  CUtensorMap tq, tdo, tk, tv;
  if (!tensor_map<T>(&tq, q, D, Sq, B * H, L::AB, L::BM, L::SWB) ||
      !tensor_map<T>(&tdo, dout, D, Sq, B * H, L::AB, L::BM, L::SWB) ||
      !tensor_map<T>(&tk, k, D, Skv, B * H, 64, 64, 128) ||
      !tensor_map<T>(&tv, v, D, Skv, B * H, 64, 64, 128))
    return cudaErrorInvalidValue;
  return launch(wide_dkv_wgmma_kernel<D, T>,
                dim3(B * H * ((Skv + 63) / 64) * L::NSPLIT), L::THREADS,
                L::SMEM, st, tq, tdo, tk, tv, (const float*)lse,
                (const float*)delta, (T*)dk, (T*)dv, Sq, Skv, causal, scale);
}

// The head dims the 16-bit Hopper backward is compiled for; a wider 16-bit
// backward, and fp32 at every wide head dim, runs the sliced kernels above.
// dQ takes the rows layout at 192 and 256, the columns layout above.
#define HVD_ROWS_BWD_DIMS(X) X(192) X(256)
#define HVD_COLS_BWD_DIMS(X) X(320) X(384) X(448) X(512) X(576)
#define HVD_WIDE_BWD_DIMS(X) HVD_ROWS_BWD_DIMS(X) HVD_COLS_BWD_DIMS(X)

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
cudaError_t launch_fwd_route(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int H, int Sq,
                             int Skv, int D, int causal, float scale,
                             cudaStream_t st) {
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

// Every route, then the rows that see no key (flash_common.cuh).
template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int Sq, int Skv, int D,
                       int causal, float scale, cudaStream_t st) {
  if (!wide_dim(D)) return cudaErrorInvalidValue;
  const cudaError_t err = launch_fwd_route<T>(q, k, v, o, lse, B, H, Sq, Skv,
                                              D, causal, scale, st);
  if (err != cudaSuccess) return err;
  return launch_none_rows<T>(v, o, lse, B, H, Sq, Skv, D, causal, st);
}

// The backward's route, as the forward's: bf16 and fp16 at the head dims of
// HVD_WIDE_BWD_DIMS to the Hopper kernels, every other wide head dim and
// dtype to the sliced ones.
template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int H, int Sq, int Skv,
                       int D, int causal, float scale, cudaStream_t st) {
  if (!wide_dim(D)) return cudaErrorInvalidValue;
  if constexpr (!kFp32<T>) {
    if (const cudaError_t err = arm_stall_word()) return err;
    switch (D) {
#define HVD_CASE(DD)                                                        \
  case DD:                                                                  \
    return launch_wide_dkv_wgmma<DD, T>(q, k, v, dout, lse, delta, dk, dv,  \
                                        B, H, Sq, Skv, causal, scale, st);
      HVD_WIDE_BWD_DIMS(HVD_CASE)
#undef HVD_CASE
    }
  }
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
  if constexpr (!kFp32<T>) {
    if (const cudaError_t err = arm_stall_word()) return err;
    switch (D) {
#define HVD_CASE(DD)                                                      \
  case DD:                                                                \
    return launch_wide_dq_rows<DD, T>(q, k, v, dout, lse, delta, dq, B, H, \
                                      Sq, Skv, causal, scale, st);
      HVD_ROWS_BWD_DIMS(HVD_CASE)
#undef HVD_CASE
#define HVD_CASE(DD)                                                      \
  case DD:                                                                \
    return launch_wide_dq_wgmma<DD, T>(q, k, v, dout, lse, delta, dq, B,  \
                                       H, Sq, Skv, causal, scale, st);
      HVD_COLS_BWD_DIMS(HVD_CASE)
#undef HVD_CASE
    }
  }
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

// Dynamic shared memory of kernel `which` (0 forward, 1 dK/dV, 2 dQ) as
// launched at head dim D: each route's own.
template <typename T>
size_t smem_bytes(int which, int D) {
  if constexpr (!kFp32<T>) {
    if (which == 0) {
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
    } else {
      switch (D) {
#define HVD_CASE(DD) \
  case DD:           \
    return which == 1 ? WideDkv<DD>::SMEM : WideDqRows<DD>::SMEM;
        HVD_ROWS_BWD_DIMS(HVD_CASE)
#undef HVD_CASE
#define HVD_CASE(DD) \
  case DD:           \
    return which == 1 ? WideDkv<DD>::SMEM : WideDq<DD>::SMEM;
        HVD_COLS_BWD_DIMS(HVD_CASE)
#undef HVD_CASE
      }
    }
  }
  if (which != 0) return bwd_smem<T>();
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
