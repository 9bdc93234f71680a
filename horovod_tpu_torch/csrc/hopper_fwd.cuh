// The Hopper flash forward, fwd_wgmma_kernel, run by flash_attention.cu at
// head dims 16-128 and by flash_attention_wide.cu at 192 and 256 (both
// bf16 and fp16): 128 query rows a block, two consumer warpgroups of 64
// rows that each hold their rows' whole O, and a producer warpgroup.
#pragma once

#include "hopper_common.cuh"

namespace hvd_flash {

// Replaces _fwd_kernel (horovod_tpu/ops/pallas_attention.py:55) for bf16 and
// fp16 at head dims 16, 32, 64 and 128 (flash_attention.cu) and 192 and 256
// (flash_attention_wide.cu); it computes what the fp32 fwd_kernel computes
// (the same mask, NEG_INF, fp32 lse, l == 0 rule and decode convention). It
// is bound by operations (see the top of flash_attention.cu), and it is
// built from what Hopper has for that:
//  - wgmma for both products. S = Q K^T takes Q and K from shared memory,
//    both K-major as stored; O += P V takes P straight from the S
//    accumulators as the A operand in registers (fp32 rounded to T) and V
//    from shared memory with the transpose bit (V is MN-major).
//  - TMA for the loads: Q, K and V come in as boxes of a 3-D tensor map
//    over (D, S, B * H), so a box is clipped at its head's last row and
//    zero-filled; the 128-byte swizzle (64-, 32-byte at D = 32, 16) is the
//    layout wgmma reads. A box row is at most 128 bytes, so a D = 128 tile
//    is two boxes side by side, a D = 256 tile four.
//  - Warp specialisation: warpgroup 2 gives up its registers
//    (setmaxnreg; above D = 128 the consumers need them: O alone is D / 2
//    fp32 a thread, so they wait with mbar_wait_bounded, fwd_wait) and one
//    of its threads keeps the loads in flight, K and V
//    in a ring of NS stages, each with its own full and empty mbarrier, so
//    a K stage is refilled as soon as S has read it. Warpgroups 0 and 1
//    each own 64 rows of the block's 128-row query tile and share the
//    stages.
//  - Overlap inside a warpgroup: tile j's S = Q K_j^T and tile j - 1's
//    O += P V_{j-1} are issued together, O's rescale runs while S does,
//    and the softmax of tile j runs while P V is in flight.
//  - Overlap across the two: they take turns issuing their products
//    (named barriers, turn_wait / turn_pass), so one warpgroup's softmax
//    runs while the other's products do.
//  - The softmax is what bounds the kernel at these head dims (the
//    products alone take about half its time, PERF.md): scores stay raw in
//    the accumulators, one FMA and one ex2.approx a score in base 2 with
//    scale * log2(e) folded in; the row max and sum run as 4 chains a row;
//    the mask is a separate instantiation for edge tiles only; lse =
//    m * scale + log(l).
// The tile is fixed per head dim: 128 query rows, and 128 keys (64 from
// D = 128 up), flash_attention.py's FWD_TILES and WIDE_FWD_TILES; the
// resolved block_q/block_k govern the backward kernels. Up to D = 128 the
// grid is (B * H, ceil(Sq / 128)), query tiles last to first; above, a
// 1-D grid in groups of heads (grouped_tile). Each output element is
// written by one block.

// At D <= 128 the consumers fit in the registers the block starts with,
// and a wait that outlasts 10 s traps; above, they need what setmaxnreg
// gives them, which a trap in the branch takes away (hopper_common.cuh), so
// the wait gives up instead and records the stall, which fails the wide
// library's next call.
template <int D>
__device__ __forceinline__ void fwd_wait(uint64_t* b, int parity) {
  if constexpr (D <= 128) {
    mbar_wait(b, parity);
  } else {
    mbar_wait_bounded(b, parity);
  }
}

// The configuration of head dim D: NC consumer warpgroups of 64 query rows
// each and a producer warpgroup per block, one block per SM (registers);
// HN keys per K/V tile; as many K/V stages (up to 3) as shared memory
// holds beside Q. At D = 128 a 128-key tile would take the
// consumers past their registers (S and O 64 fp32 each, P 32).
template <int D>
struct HopperFwd {
  static constexpr int NC = 2;  // they take turns (turn_wait / turn_pass)
  static constexpr int HN = D <= 64 ? 128 : 64;
  static constexpr int HM = 64 * NC;
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int SW = D * 2 < 128 ? D * 2 : 128;  // swizzle = box row
  static constexpr int BOX = SW / 2;                     // columns of a box
  static constexpr int NBOX = D / BOX;                   // boxes across D
  static constexpr int Q_BYTES = HM * D * 2;
  static constexpr int KV_BYTES = HN * D * 2;
  static constexpr int FIT = (227 * 1024 - 2048 - Q_BYTES) / (2 * KV_BYTES);
  static constexpr int NS = FIT < 3 ? FIT : 3;  // K/V stages
  static_assert(NS >= 2, "two K/V stages fit");
  static constexpr int BAR_BYTES = 8 * (1 + 4 * NS);
  // Q, the K/V stages, barriers, and room to align the base to 1024 bytes
  // (the 128-byte swizzle's period).
  static constexpr int SMEM = Q_BYTES + 2 * NS * KV_BYTES + BAR_BYTES + 1024;
};

// Named barriers 1 and 2 order the two consumer warpgroups' products:
// warpgroup w waits on barrier 1 + w (its 128 threads plus the other
// warpgroup's 128 arrivals) before it issues, and arrives on the other's
// after, so one warpgroup's softmax runs while the other's products do.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

// S = Q K^T for one warpgroup: D / 16 wgmma k-steps, 16 columns (32
// bytes) each, from the descriptors of its 64 Q rows and of the K stage
// (both K-major; the next box is HM or HN rows of SW bytes further).
template <int D, typename T, int HN = HopperFwd<D>::HN>
__device__ __forceinline__ void issue_qk(float (&s)[HN / 2], uint64_t q_desc,
                                         uint64_t k_desc) {
  using L = HopperFwd<D>;
#pragma unroll
  for (int b = 0; b < L::NBOX; ++b)
#pragma unroll
    for (int ks = 0; ks < L::BOX / 16; ++ks)
      wgmma_ss<HN, T>(s, q_desc + ((b * L::HM * L::SW + ks * 32) >> 4),
                      k_desc + ((b * HN * L::SW + ks * 32) >> 4),
                      (b | ks) != 0);
}

// O += P V: HN / 16 k-steps of 16 keys (16 rows of the V stage each; the
// descriptor's leading byte offset reaches V's next box of columns).
template <int D, typename T, int HN = HopperFwd<D>::HN>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&p)[HN / 16][4],
                                         uint64_t v_desc) {
  using L = HopperFwd<D>;
#pragma unroll
  for (int kk = 0; kk < HN / 16; ++kk)
    wgmma_rs<D, T>(acc, p[kk], v_desc + ((kk * 16 * L::SW) >> 4), 1);
}

// Online softmax of one tile of raw scores, in place: s becomes P
// relative to the new running max m (raw units), l is rescaled and gains
// this tile's row sums (this lane's share), alpha rescales O. MASK (edge
// tiles only, a separate instantiation) masks keys past Skv and, under the
// causal mask, past each row's position.
// One FMA and one ex2 a score: p = 2^(s * scale log2 e - m * scale log2 e).
// The row max and the row sum run as 4 independent chains a row, so that
// their latency, and not the 2 warps a scheduler holds, sets the pace.
template <int HN, bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[HN / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int k0, int row0, int Sq,
                                             int Skv, int causal, float sl2,
                                             int t) {
  float mx[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) mx[r][c] = m[r];
#pragma unroll
  for (int i = 0; i < HN / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * i + e];
      if constexpr (MASK) {
        const int col = k0 + i * 8 + 2 * t + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        if (col >= Skv || (causal && col > row + Skv - Sq)) x = NEG_INF;
      }
      s[4 * i + e] = x;
      float& c = mx[e >> 1][(i & 1) * 2 + (e & 1)];
      c = fmaxf(c, x);
    }
  float mul[2], add[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
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
  float sum[2][4] = {};
#pragma unroll
  for (int i = 0; i < HN / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(s[4 * i + e], mul[e >> 1], add[e >> 1]));
      s[4 * i + e] = p;
      sum[e >> 1][(i & 1) * 2 + (e & 1)] += p;
    }
  // This lane's share of the row sums; the quad is summed at the end.
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * alpha[r] + ((sum[r][0] + sum[r][1]) +
                              (sum[r][2] + sum[r][3]));
}

// P as T A fragments, 16 keys a k-step, straight from the accumulators.
template <typename T, int HN>
__device__ __forceinline__ void pack_p(uint32_t (&p)[HN / 16][4],
                                       const float (&s)[HN / 2]) {
#pragma unroll
  for (int kk = 0; kk < HN / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[kk][i] = pack16<T>(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

template <int D, typename T>
__global__ void __launch_bounds__(HopperFwd<D>::THREADS, 1)
    fwd_wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                     __grid_constant__ const CUtensorMap tk,
                     __grid_constant__ const CUtensorMap tv,
                     T* __restrict__ o, float* __restrict__ lse, int Sq,
                     int Skv, int causal, float scale) {
  using L = HopperFwd<D>;
  constexpr int NS = L::NS, NC = L::NC, HM = L::HM, HN = L::HN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  T* Qs = reinterpret_cast<T*>(base);
  T* Ks = reinterpret_cast<T*>(base + L::Q_BYTES);  // NS stages
  T* Vs = reinterpret_cast<T*>(base + L::Q_BYTES + NS * L::KV_BYTES);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + L::Q_BYTES +
                                                 2 * NS * L::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + NS;
  uint64_t* k_empty = v_full + NS;
  uint64_t* v_empty = k_empty + NS;

  // Above D = 128 a 1-D grid in groups of heads (grouped_tile); up to
  // 128 the grid is (B * H, query tiles), query tiles last to first.
  int bh, q_start;
  if constexpr (D > 128) {
    int qt;
    grouped_tile((Sq + HM - 1) / HM, Skv, D, bh, qt);
    q_start = qt * HM;
  } else {
    bh = blockIdx.x;
    q_start = (gridDim.y - 1 - blockIdx.y) * HM;
  }
  const int nkb = key_tiles(q_start, Sq, Skv, causal, HM, HN);
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
    // Producer: one thread keeps the TMA loads in flight.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == NC * 128) {
      mbar_expect_tx(q_full, L::Q_BYTES);
      for (int b = 0; b < L::NBOX; ++b)
        tma_load(Qs + b * HM * L::BOX, &tq, q_full, b * L::BOX, q_start, bh);
      for (int j = 0; j < nkb; ++j) {
        const int st = j % NS, ph = (j / NS) & 1;
        if (j >= NS) fwd_wait<D>(k_empty + st, ph ^ 1);
        mbar_expect_tx(k_full + st, L::KV_BYTES);
        for (int b = 0; b < L::NBOX; ++b)
          tma_load(Ks + st * HN * D + b * HN * L::BOX, &tk, k_full + st,
                   b * L::BOX, j * HN, bh);
        if (j >= NS) fwd_wait<D>(v_empty + st, ph ^ 1);
        mbar_expect_tx(v_full + st, L::KV_BYTES);
        for (int b = 0; b < L::NBOX; ++b)
          tma_load(Vs + st * HN * D + b * HN * L::BOX, &tv, v_full + st,
                   b * L::BOX, j * HN, bh);
      }
    }
  } else {
    // Consumers: warpgroup wg owns query rows [q_start + 64 wg, + 64).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int q0 = q_start + wg * 64;
    const int row0 = q0 + warp * 16 + g;  // this thread's rows: +0, +8
    const float sl2 = scale * LOG2E;
    const uint64_t q_desc =
        gmma_desc(smem_u32(Qs) + wg * 64 * L::SW, 16, 8 * L::SW, L::SW);
    const uint64_t k_desc = gmma_desc(smem_u32(Ks), 16, 8 * L::SW, L::SW);
    const uint64_t v_desc =
        gmma_desc(smem_u32(Vs), HN * L::SW, 8 * L::SW, L::SW);
    constexpr int KV_STEP = L::KV_BYTES >> 4;  // a stage, in 16 bytes
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    auto edge_tile = [&](int j) {
      const int k0 = j * HN;
      return k0 + HN > Skv || (causal && k0 + HN - 1 > q0 + (Skv - Sq));
    };
    // The two warpgroups take turns issuing their products (turn_wait /
    // turn_pass): warpgroup 1 passes the first turn to warpgroup 0, and
    // warpgroup 0 takes one more turn after its stores, so every arrival
    // is waited for.
    if (wg == 1) turn_pass(wg);

    float s[HN / 2], acc[D / 2], m[2] = {NEG_INF, NEG_INF},
                                 l[2] = {0.f, 0.f}, alpha[2];
    uint32_t p[HN / 16][4];
    auto softmax = [&](int j) {
      if (edge_tile(j))
        softmax_tile<HN, true>(s, m, l, alpha, j * HN, row0, Sq, Skv,
                               causal, sl2, t);
      else
        softmax_tile<HN, false>(s, m, l, alpha, j * HN, row0, Sq, Skv,
                                causal, sl2, t);
    };
    // O *= alpha, the last softmax's correction, before O gains P V.
    auto rescale = [&]() {
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        acc[4 * i] *= alpha[0];
        acc[4 * i + 1] *= alpha[0];
        acc[4 * i + 2] *= alpha[1];
        acc[4 * i + 3] *= alpha[1];
      }
    };
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    fwd_wait<D>(q_full, 0);
    if (nkb > 0) {
      fwd_wait<D>(k_full, 0);
      turn_wait(wg);
      wgmma_fence();
      issue_qk<D, T>(s, q_desc, k_desc);
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<0>();
      pin(s);
      release(k_empty);
      softmax(0);
      pack_p<T, HN>(p, s);
    }
    for (int j = 1; j < nkb; ++j) {
      const int st = j % NS, sp = (j - 1) % NS;
      fwd_wait<D>(k_full + st, (j / NS) & 1);
      turn_wait(wg);
      wgmma_fence();
      issue_qk<D, T>(s, q_desc, k_desc + st * KV_STEP);
      wgmma_commit();
      rescale();  // while S runs
      fwd_wait<D>(v_full + sp, ((j - 1) / NS) & 1);
      wgmma_fence();
      issue_pv<D, T>(acc, p, v_desc + sp * KV_STEP);
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<1>();  // S of tile j; P V of tile j - 1 may still run
      pin(s);
      release(k_empty + st);
      softmax(j);
      wgmma_wait<0>();
      pin(acc);
      pin(s);  // p is rewritten only after the product that reads it
      release(v_empty + sp);
      pack_p<T, HN>(p, s);
    }
    if (nkb > 0) {
      const int sp = (nkb - 1) % NS;
      fwd_wait<D>(v_full + sp, ((nkb - 1) / NS) & 1);
      turn_wait(wg);
      rescale();
      wgmma_fence();
      issue_pv<D, T>(acc, p, v_desc + sp * KV_STEP);
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<0>();
      pin(acc);
      release(v_empty + sp);
    }

    T* op = o + (size_t)bh * Sq * D;
    float* lp = lse + (size_t)bh * Sq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = row0 + 8 * r;
      if (row >= Sq) continue;
      const float ls = l[r] == 0.f ? 1.f : l[r];
      const float inv = 1.f / ls;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<uint32_t*>(op + (size_t)row * D + i * 8 + 2 * t) =
            pack16<T>(acc[4 * i + 2 * r] * inv, acc[4 * i + 2 * r + 1] * inv);
      if (t == 0) lp[row] = m[r] * scale + logf(ls);
    }
    if (wg == 0) turn_wait(wg);  // warpgroup 1's last pass
  }
}

template <int D, typename T>
cudaError_t launch_fwd_wgmma(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int H, int Sq,
                             int Skv, int causal, float scale,
                             cudaStream_t st) {
  using L = HopperFwd<D>;
  CUtensorMap tq, tk, tv;
  if (!tensor_map<T>(&tq, q, D, Sq, B * H, L::BOX, L::HM, L::SW) ||
      !tensor_map<T>(&tk, k, D, Skv, B * H, L::BOX, L::HN, L::SW) ||
      !tensor_map<T>(&tv, v, D, Skv, B * H, L::BOX, L::HN, L::SW))
    return cudaErrorInvalidValue;
  const int nqt = (Sq + L::HM - 1) / L::HM;
  const dim3 grid = D > 128 ? dim3(B * H * nqt) : dim3(B * H, nqt);
  return launch(fwd_wgmma_kernel<D, T>, grid,
                L::THREADS, L::SMEM, st, tq, tk, tv, (T*)o, (float*)lse, Sq,
                Skv, causal, scale);
}

}  // namespace hvd_flash
