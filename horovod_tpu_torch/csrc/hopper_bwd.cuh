// The Hopper flash backward in bf16 and fp16, shared by flash_attention.cu
// (head dims 16-128) and flash_attention_wide.cu (192-576); the columns dQ
// of 320-576 (wide_dq_wgmma_kernel) stays in the wide library. Each kernel
// is a producer warpgroup that keeps TMA loads in flight in an mbarrier ring
// and two consumer warpgroups that issue wgmma, and computes every score
// product once per (query tile, key tile); each output element is written
// by one block in a fixed order, with no atomics, so dK, dV and dQ are
// bit-equal from run to run.
//  - dkv_rows_wgmma_kernel (dK/dV at D = 16-128): 128 keys a block, each
//    consumer warpgroup 64 of them end to end, K and V resident, Q and dO
//    streamed with each tile's -lse log2(e) and delta.
//  - dq_rows_wgmma_kernel (dQ at D = 16-256): 128 query rows a block, each
//    consumer warpgroup 64 of them end to end, Q and dO resident, K and V
//    streamed.
//  - wide_dkv_wgmma_kernel (dK/dV at D = 192-576): 64 keys a block, the
//    score products split between the two warpgroups (see its comment).
// They replace _bwd_dkv_kernel (horovod_tpu/ops/pallas_attention.py:114)
// and _bwd_dq_kernel (:174) and compute what the fp32 dkv_kernel and
// dq_kernel compute (flash_attention.cu): the decode convention's causal
// mask, NEG_INF masking with fully masked tiles, keys >= Skv masked, lse
// and delta contiguous fp32 (B, H, Sq), dK and dQ scaled once at the end.
// All three are bound by operations (chip_smoke.py computes each bound).
#pragma once

#include "hopper_fwd.cuh"

namespace hvd_flash {

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

// The split kernels: wide_dkv_wgmma_kernel below and wide_dq_wgmma_kernel
// (flash_attention_wide.cu) split each tile pair's two score products
// between the consumer warpgroups: warpgroup 0 computes the scores (S, or
// S^T), warpgroup 1 dP = dO V^T (or dP^T), once per tile pair each, and P
// crosses from 0 to 1 in fp32 through shared memory, each thread's values
// to the thread of the same place in the other warpgroup (no bank
// conflict). Named barriers 1 and 2 order the exchange.
// A stage of either split kernel is read twice: by its tile's scores
// and, one tile later, by its tile's output product, so a ring of two
// leaves the next load little time ahead of its use. Each kernel takes the
// largest tile that two stages beside its resident operands leave room
// for, and a third stage where that tile still fits with it.

// Shared memory of wide_dq_wgmma_kernel at head dim D with key tiles of hn
// and ns stages: Q and dO resident, the K and V stages, P (fp32), two dS tiles,
// barriers, and room to align the base to 1024 bytes.
constexpr int wide_dq_bytes(int D, int hn, int ns) {
  return 2 * 64 * D * 2 + 2 * ns * hn * D * 2 + 64 * hn * 4 +
         2 * 64 * hn * 2 + 8 * (1 + 4 * ns) + 1024;
}

// Shared memory of wide_dkv_wgmma_kernel at head dim D with query tiles of
// bm and ns stages: K and V resident, the Q and dO stages with their rows'
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
// D = 192-576 (flash_attention_wide.cu). Per query tile j (TMA, NS stages of Q and dO; K and V
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

// ----------------------------------------------- the "rows" kernels ---
// Both rows kernels are fwd_wgmma_kernel's structure (hopper_fwd.cuh) with
// the backward's products: a block holds 128 rows of one operand pair
// resident (Q and dO for dQ, K and V for dK/dV), each consumer warpgroup
// owns 64 of them end to end, so both warpgroups run the same code (the
// condition for ptxas not to serialize a wgmma with a register A operand),
// and the two take turns issuing their products (turn_wait / turn_pass),
// so that one's elementwise work runs while the other's products do. The
// other operand pair streams through NS stages by TMA. Tiles are boxes of
// fwd_wgmma_kernel's geometry (HopperFwd<D>: a 128-, 64- or 32-byte
// swizzle, a box row at most 128 bytes), so issue_qk and issue_pv serve
// here too: S = A B^T from two K-major tiles, and acc += P B with P a
// register A operand (the accumulator layout packed to T, pack_p) and B an
// MN-major tile. Masking runs on edge tiles only. Blocks take their
// (head, tile) from grouped_tile. The consumers take setmaxnreg's 240
// registers, so every wait is mbar_wait_bounded: a trap in the branch would
// hold them to the 168 a 384-thread block starts with (hopper_common.cuh).

// dQ: 128 query rows a block, HN keys a K/V tile, NS stages. Up to D = 64
// the key tile is 128 keys (7-9% faster than 64 at D = 64), at 128 it is 64
// (S, dP and dQ would pass the registers); above, the largest (64 to 16)
// that three stages beside Q and dO leave room for
// (tools/flash_bwd_variants.py times other choices).
constexpr int DQ_STAGES = 3;

constexpr int dq_rows_bytes(int D, int hn, int ns) {
  return 2 * 128 * D * 2 + 2 * ns * hn * D * 2 + 8 * (1 + 4 * ns) + 1024;
}
constexpr int dq_rows_keys(int D) {
  if (D <= 128) return D <= 64 ? 128 : 64;
  for (int hn = 64; hn >= 16; hn -= 16)
    if (dq_rows_bytes(D, hn, DQ_STAGES) <= SMEM_MAX) return hn;
  return 0;
}

template <int D>
struct HopperDq {
  using G = HopperFwd<D>;  // the tiles' boxes and swizzle
  static constexpr int THREADS = 384;
  static constexpr int HM = G::HM;  // 128
  static constexpr int HN = dq_rows_keys(D);
  static constexpr int NS = DQ_STAGES;
  static constexpr int QO_BYTES = HM * D * 2;
  static constexpr int KV_BYTES = HN * D * 2;
  static constexpr int SMEM = dq_rows_bytes(D, HN, NS);
  static_assert(D % 16 == 0 && D >= 16 && D <= 256, "a rows head dim");
  static_assert(HN % 16 == 0 && HN >= 16 && SMEM <= SMEM_MAX,
                "a tile that fits");
};

// Replaces _bwd_dq_kernel (pallas_attention.py:174) for bf16 and fp16 at
// D = 16-256: per key tile j each warpgroup issues S = Q_w K_j^T and
// dP = dO_w V_j^T (TMA, NS stages of K and V) with its last tile's
// dQ_w += dS K_{j-1} (dS as T straight from registers, K MN-major), forms
// P = exp(scale S - lse) (zero where an edge hides the key) and
// dS = P (dP - delta) while that product runs, and the two take turns
// issuing. dQ is scaled once at the end.
template <int D, typename T>
__global__ void __launch_bounds__(HopperDq<D>::THREADS, 1)
    dq_rows_wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                         __grid_constant__ const CUtensorMap tdo,
                         __grid_constant__ const CUtensorMap tk,
                         __grid_constant__ const CUtensorMap tv,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dq,
                         int Sq, int Skv, int causal, float scale) {
  using L = HopperDq<D>;
  using G = typename L::G;
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
      for (int b = 0; b < G::NBOX; ++b) {
        tma_load(Qs + b * HM * G::BOX, &tq, q_full, b * G::BOX, q_start, bh);
        tma_load(dOs + b * HM * G::BOX, &tdo, q_full, b * G::BOX, q_start,
                 bh);
      }
      for (int j = 0; j < nkb; ++j) {
        const int st = j % NS, ph = (j / NS) & 1;
        if (j >= NS) mbar_wait_bounded(k_empty + st, ph ^ 1);
        mbar_expect_tx(k_full + st, L::KV_BYTES);
        for (int b = 0; b < G::NBOX; ++b)
          tma_load(Ks + st * HN * D + b * HN * G::BOX, &tk, k_full + st,
                   b * G::BOX, j * HN, bh);
        if (j >= NS) mbar_wait_bounded(v_empty + st, ph ^ 1);
        mbar_expect_tx(v_full + st, L::KV_BYTES);
        for (int b = 0; b < G::NBOX; ++b)
          tma_load(Vs + st * HN * D + b * HN * G::BOX, &tv, v_full + st,
                   b * G::BOX, j * HN, bh);
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
  // Q_w, dO_w, K_j and V_j K-major for the scores, K_j MN-major for dQ.
  const uint64_t q_desc =
      gmma_desc(smem_u32(Qs) + wg * 64 * G::SW, 16, 8 * G::SW, G::SW);
  const uint64_t do_desc =
      gmma_desc(smem_u32(dOs) + wg * 64 * G::SW, 16, 8 * G::SW, G::SW);
  const uint64_t k_desc = gmma_desc(smem_u32(Ks), 16, 8 * G::SW, G::SW);
  const uint64_t v_desc = gmma_desc(smem_u32(Vs), 16, 8 * G::SW, G::SW);
  const uint64_t kmn_desc =
      gmma_desc(smem_u32(Ks), HN * G::SW, 8 * G::SW, G::SW);
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
  // flight reads (pk) must not be written before its wait. The mask is a
  // separate instantiation, run on edge tiles only (per element on every
  // tile, it took a third of the kernel, tools/flash_bwd_variants.py).
  auto dscores_tile = [&](int j, auto masked) {
    const int k0 = j * HN;
#pragma unroll
    for (int i = 0; i < HN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(s[4 * i + e], sl2, nl2[e >> 1]));
        if constexpr (decltype(masked)::value) {
          if (!visible(row0 + 8 * (e >> 1), k0 + 8 * i + 2 * t + (e & 1), Sq,
                       Skv, causal))
            p = 0.f;
        }
        dp[4 * i + e] = p * (dp[4 * i + e] - dl[e >> 1]);
      }
  };
  auto dscores = [&](int j) {
    const int k0 = j * HN;
    if (k0 + HN > Skv || (causal && k0 + HN - 1 > q0 + (Skv - Sq)))
      dscores_tile(j, std::true_type());
    else
      dscores_tile(j, std::false_type());
  };

  mbar_wait_bounded(q_full, 0);
  if (nkb > 0) {
    mbar_wait_bounded(k_full, 0);
    mbar_wait_bounded(v_full, 0);
    turn_wait(wg);
    wgmma_fence();
    issue_qk<D, T, HN>(s, q_desc, k_desc);
    issue_qk<D, T, HN>(dp, do_desc, v_desc);
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
    issue_qk<D, T, HN>(s, q_desc, k_desc + st * KV_STEP);
    issue_qk<D, T, HN>(dp, do_desc, v_desc + st * KV_STEP);
    wgmma_commit();
    issue_pv<D, T, HN>(acc, pk, kmn_desc + sp * KV_STEP);  // dQ += dS K
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
    issue_pv<D, T, HN>(acc, pk, kmn_desc + ((nkb - 1) % NS) * KV_STEP);
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
cudaError_t launch_dq_rows(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int B, int H, int Sq,
                           int Skv, int causal, float scale,
                           cudaStream_t st) {
  using L = HopperDq<D>;
  using G = typename L::G;
  CUtensorMap tq, tdo, tk, tv;
  if (!tensor_map<T>(&tq, q, D, Sq, B * H, G::BOX, L::HM, G::SW) ||
      !tensor_map<T>(&tdo, dout, D, Sq, B * H, G::BOX, L::HM, G::SW) ||
      !tensor_map<T>(&tk, k, D, Skv, B * H, G::BOX, L::HN, G::SW) ||
      !tensor_map<T>(&tv, v, D, Skv, B * H, G::BOX, L::HN, G::SW))
    return cudaErrorInvalidValue;
  return launch(dq_rows_wgmma_kernel<D, T>,
                dim3(B * H * ((Sq + L::HM - 1) / L::HM)), L::THREADS, L::SMEM,
                st, tq, tdo, tk, tv, (const float*)lse, (const float*)delta,
                (T*)dq, Sq, Skv, causal, scale);
}

// dK/dV: 128 keys a block (HK), BM query rows a Q/dO tile, NS stages, each
// stage with its rows' -lse log2(e) and delta (fp32); K and V resident.
constexpr int DKV_ROWS = 64;
constexpr int DKV_STAGES = 3;

template <int D>
struct HopperDkv {
  using G = HopperFwd<D>;  // the tiles' boxes and swizzle
  static constexpr int THREADS = 384;
  static constexpr int HK = G::HM;  // 128 keys: issue_qk's A is HM rows a box
  static constexpr int BM = DKV_ROWS;
  static constexpr int NS = DKV_STAGES;
  static constexpr int KV_BYTES = HK * D * 2;
  static constexpr int QO_BYTES = BM * D * 2;
  static constexpr int R_BYTES = 2 * BM * 4;
  static constexpr int SMEM =
      2 * KV_BYTES + NS * (2 * QO_BYTES + R_BYTES) + 8 * (1 + 2 * NS) + 1024;
  static_assert(D % 16 == 0 && D >= 16 && D <= 128, "a narrow head dim");
  static_assert(BM % 16 == 0 && BM >= 16 && BM <= 128, "a query tile");
  static_assert(SMEM <= SMEM_MAX, "fits a block's shared memory");
};

// Replaces _bwd_dkv_kernel (pallas_attention.py:114) for bf16 and fp16 at
// D = 16-128. Per query tile j (TMA, NS stages of Q and dO, with the rows'
// -lse log2(e) and delta staged by the producer warp beside them: read
// from device memory by the consumers they held up every tile of the wide
// kernel, PERF.md): each warpgroup issues S^T = K_w Q_j^T and
// dP^T = V_w dO_j^T, forms P^T = exp(scale S^T - lse) (zero where an edge
// hides the pair) and dS^T = P^T (dP^T - delta) in registers, and issues
// dV_w += P^T dO_j and dK_w += dS^T Q_j with P^T and dS^T as register A
// operands (dO and Q MN-major). A tile's score products and its output
// products are two turns, so one warpgroup forms P^T and dS^T while the
// other's products run. (Issuing a tile's output products with the next
// tile's scores, as dq_rows_wgmma_kernel does, measured 4% slower at
// D = 64 and past the registers at 128: tools/flash_bwd_variants.py.) Key
// tiles go first to last, since under the causal mask the first is seen
// by the most query tiles. dK is scaled once at the end.
template <int D, typename T>
__global__ void __launch_bounds__(HopperDkv<D>::THREADS, 1)
    dkv_rows_wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                          __grid_constant__ const CUtensorMap tdo,
                          __grid_constant__ const CUtensorMap tk,
                          __grid_constant__ const CUtensorMap tv,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int Sq,
                          int Skv, int causal, float scale) {
  using L = HopperDkv<D>;
  using G = typename L::G;
  constexpr int NS = L::NS, BM = L::BM, HK = L::HK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  T* Ks = reinterpret_cast<T*>(base);
  T* Vs = reinterpret_cast<T*>(base + L::KV_BYTES);
  T* Qs = reinterpret_cast<T*>(base + 2 * L::KV_BYTES);  // NS stages
  T* dOs = reinterpret_cast<T*>(base + 2 * L::KV_BYTES + NS * L::QO_BYTES);
  // NS stages of (-lse log2(e), delta) for BM query rows each.
  float* Rs = reinterpret_cast<float*>(base + 2 * L::KV_BYTES +
                                       2 * NS * L::QO_BYTES);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(Rs + NS * 2 * BM);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + NS;

  const int nkt = (Skv + HK - 1) / HK;
  int bh, x;
  grouped_tile(nkt, Sq, D, bh, x);
  const int k_start = (nkt - 1 - x) * HK;
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
        for (int b = 0; b < G::NBOX; ++b) {
          tma_load(Ks + b * HK * G::BOX, &tk, kv_full, b * G::BOX, k_start,
                   bh);
          tma_load(Vs + b * HK * G::BOX, &tv, kv_full, b * G::BOX, k_start,
                   bh);
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
          for (int b = 0; b < G::NBOX; ++b) {
            tma_load(Qs + st * BM * D + b * BM * G::BOX, &tq, full + st,
                     b * G::BOX, q0, bh);
            tma_load(dOs + st * BM * D + b * BM * G::BOX, &tdo, full + st,
                     b * G::BOX, q0, bh);
          }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns keys [k_start + 64 wg, + 64).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int kw = k_start + wg * 64;
  const int key0 = kw + warp * 16 + (lane >> 2);  // this thread's keys: +0, +8
  const float sl2 = scale * LOG2E;
  // K_w, V_w (A) and Q_j, dO_j (B) K-major for the scores; Q_j and dO_j
  // MN-major for the output products.
  const uint64_t k_desc =
      gmma_desc(smem_u32(Ks) + wg * 64 * G::SW, 16, 8 * G::SW, G::SW);
  const uint64_t v_desc =
      gmma_desc(smem_u32(Vs) + wg * 64 * G::SW, 16, 8 * G::SW, G::SW);
  const uint64_t q_desc = gmma_desc(smem_u32(Qs), 16, 8 * G::SW, G::SW);
  const uint64_t do_desc = gmma_desc(smem_u32(dOs), 16, 8 * G::SW, G::SW);
  const uint64_t qmn_desc =
      gmma_desc(smem_u32(Qs), BM * G::SW, 8 * G::SW, G::SW);
  const uint64_t domn_desc =
      gmma_desc(smem_u32(dOs), BM * G::SW, 8 * G::SW, G::SW);
  constexpr int QO_STEP = L::QO_BYTES >> 4;  // a stage, in 16 bytes
  if (wg == 1) turn_pass(wg);

  float dK[D / 2], dV[D / 2], s[BM / 2], dp[BM / 2];
  uint32_t pa[BM / 16][4], da[BM / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dK[i] = dV[i] = 0.f;

  // P^T over S^T and dS^T over dP^T of tile j, in fp32: key row +8
  // (e >> 1), query column q0 + 8 i + 2 t + (e & 1), whose -lse log2(e)
  // and delta its stage holds. The mask is a separate instantiation, run
  // on edge tiles only.
  auto dscores_tile = [&](int j, auto masked) {
    const int q0 = (qb0 + j) * BM;
    const float* rs = Rs + (j % NS) * 2 * BM;
#pragma unroll
    for (int i = 0; i < BM / 8; ++i) {
      const float2 nl = *reinterpret_cast<const float2*>(rs + 8 * i + 2 * t);
      const float2 dl =
          *reinterpret_cast<const float2*>(rs + BM + 8 * i + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(s[4 * i + e], sl2, (e & 1) ? nl.y : nl.x));
        if constexpr (decltype(masked)::value) {
          if (!visible(q0 + 8 * i + 2 * t + (e & 1), key0 + 8 * (e >> 1), Sq,
                       Skv, causal))
            p = 0.f;
        }
        dp[4 * i + e] = p * (dp[4 * i + e] - ((e & 1) ? dl.y : dl.x));
        s[4 * i + e] = p;
      }
    }
  };
  auto dscores = [&](int j) {
    const int q0 = (qb0 + j) * BM;
    if (q0 + BM > Sq || kw + 64 > Skv || (causal && kw + 63 > q0 + off))
      dscores_tile(j, std::true_type());
    else
      dscores_tile(j, std::false_type());
  };

  mbar_wait_bounded(kv_full, 0);
  for (int j = 0; j < n; ++j) {
    const int st = j % NS;
    mbar_wait_bounded(full + st, (j / NS) & 1);
    turn_wait(wg);
    wgmma_fence();
    issue_qk<D, T, BM>(s, k_desc, q_desc + st * QO_STEP);  // S^T = K_w Q_j^T
    issue_qk<D, T, BM>(dp, v_desc, do_desc + st * QO_STEP);  // dP^T
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<0>();
    pin(s);
    pin(dp);
    dscores(j);
    pack_p<T, BM>(pa, s);
    pack_p<T, BM>(da, dp);
    turn_wait(wg);
    wgmma_fence();
    issue_pv<D, T, BM>(dV, pa, domn_desc + st * QO_STEP);  // dV += P^T dO_j
    issue_pv<D, T, BM>(dK, da, qmn_desc + st * QO_STEP);   // dK += dS^T Q_j
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<0>();
    pin(dK);
    pin(dV);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
  }
  if (wg == 0) turn_wait(wg);  // warpgroup 1's last pass

  T* dkp = dk + (size_t)bh * Skv * D;
  T* dvp = dv + (size_t)bh * Skv * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= Skv) continue;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const size_t at = (size_t)key * D + i * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dkp + at) =
          pack16<T>(dK[4 * i + 2 * r] * scale, dK[4 * i + 2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvp + at) =
          pack16<T>(dV[4 * i + 2 * r], dV[4 * i + 2 * r + 1]);
    }
  }
}

template <int D, typename T>
cudaError_t launch_dkv_rows(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int B,
                            int H, int Sq, int Skv, int causal, float scale,
                            cudaStream_t st) {
  using L = HopperDkv<D>;
  using G = typename L::G;
  CUtensorMap tq, tdo, tk, tv;
  if (!tensor_map<T>(&tq, q, D, Sq, B * H, G::BOX, L::BM, G::SW) ||
      !tensor_map<T>(&tdo, dout, D, Sq, B * H, G::BOX, L::BM, G::SW) ||
      !tensor_map<T>(&tk, k, D, Skv, B * H, G::BOX, L::HK, G::SW) ||
      !tensor_map<T>(&tv, v, D, Skv, B * H, G::BOX, L::HK, G::SW))
    return cudaErrorInvalidValue;
  return launch(dkv_rows_wgmma_kernel<D, T>,
                dim3(B * H * ((Skv + L::HK - 1) / L::HK)), L::THREADS,
                L::SMEM, st, tq, tdo, tk, tv, (const float*)lse,
                (const float*)delta, (T*)dk, (T*)dv, Sq, Skv, causal, scale);
}

}  // namespace hvd_flash
