// Wire codecs of the device plane's compressed ring, sm_90a.
//
// Replaces no Pallas kernel: on the TPU the data plane is XLA over ICI and
// has no codec. The JAX package's native core compresses the fp32 steps of
// its TCP ring on the host (horovod_tpu/core/src/codec.cc CodecEncode and
// CodecDecodeRange, driven by collectives.cc:357-491 RingCompressed) and
// keeps int8 error-feedback residuals per tensor (operations.cc:261-292).
// These are that arithmetic on the card, bit for bit:
//
//   hvd_codec_encode:         one block of `count` fp32 values to wire
//                             bytes: bf16 (round to nearest even by a bias
//                             on the bits), fp16 (the core's truncating
//                             float-to-half), or int8 (a 4-byte fp32 scale
//                             maxabs / 127, then `count` signed bytes);
//   hvd_codec_decode_reduce:  decode a block and combine it into an fp32
//                             range with the core's ReduceBuffer op (sum,
//                             min, max, product) or overwrite it (the
//                             allgather); the decoded values never go to
//                             memory;
//   hvd_codec_error_feedback: the int8 feedback over a whole fused response,
//                             one scale per tensor: x += r; xq = the int8
//                             round trip of x; r = x - xq; x = xq.
//
// Bound: bytes. Encode reads 4 B and writes 2 B (bf16, fp16) or 1 B (int8)
// per element; decode-reduce reads 1-2 B and 4 B and writes 4 B (the
// allgather's copy does not read the fp32 range); the feedback reads x and
// r and writes both (16 B). Each does a few operations per element, far
// below the card's operations per byte. At a ring step of 6.4M values a
// call moves 32-64 MB: HBM at 3.35 TB/s with a latency near a microsecond
// needs some 3 MB in flight to stay busy.
//
// Encode and decode-reduce are one element-wise scheme. Each thread moves
// 16 bytes of fp32 per access (four values) and the matching 8 bytes of
// bf16/fp16 or 4 bytes of int8, with kUnroll such accesses in flight; the
// grid covers the card once (kBlocksPerSm blocks on every SM) and strides
// over the vectors, so every thread does the same number of them to within
// one. A vector access needs both sides at the same phase in their words:
// block 0 moves the fp32 side's scalar head up to its 16-byte boundary and
// the scalar tail. Where the wire's phase differs from the fp32 side's,
// the launch takes the widest access both allow: two values at an even
// difference, one at an odd one. The device plane's ring places every
// chunk's wire bytes at its chunk's phase (ops/codec.py RingMember), so
// its steps all take the four-wide path.
//
// int8's maxabs is the core's sequential `if (!(a <= maxabs)) maxabs = a`,
// in which a NaN does not stick: the next element replaces it. The result
// is the largest |x| after the block's last NaN, or NaN when the block ends
// on one. int8 encode is two launches. The max pass gives every chunk of
// kEncodeChunk elements a partial (the chunk's last NaN index and the
// largest |x| after it; a chunk that holds a NaN reads its elements after
// the last one a second time); the last of its blocks to finish, known by a
// device counter, merges all partials in index order (the merge is
// associative, not commutative) and writes the scale into the wire's first
// 4 bytes, then sets the counter back to 0. The quantizer reads the scale
// from the wire, and x a second time: from L2 when the block fits there (a
// ring step's 25.6 MB chunk does). The host never reads the scale. The
// feedback keeps its own three launches (a max pass, one warp per tensor
// that merges its chunks, the update) over kChunk elements a block.
//
// Every operation is one IEEE fp32 operation, rounded to nearest
// (__fadd_rn, __fmul_rn, __fdiv_rn): nvcc would otherwise contract a
// decode's product and the sum into one fused multiply-add, which the
// core's C++ does not do. Min and max are the core's std::min/std::max
// (a NaN on the right keeps the left). The clamp is
// std::max(-127, std::min(127, v)), so a NaN becomes 127; __float2int_rn
// rounds half to even, as lrintf does. bf16 keeps the core's bias on the
// bits: cvt.rn.bf16.f32 would make the canonical NaN of a NaN, where the
// bias wraps 0x7FFFFFFF to -0. fp16 takes the card's conversions where
// they equal the core's bit for bit (FloatToHalfCvt, HalfToFloatCvt).

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "core_convert.cuh"

namespace {

using namespace hvd;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kChunk = 4096;
constexpr long long kEncodeChunk = 16384;
constexpr int kUnroll = 4;
constexpr int kBlocksPerSm = 4;
constexpr unsigned kFull = 0xffffffffu;

// WireCodecId values of core/src/codec.h (kInt8 and the like are the
// tensors' DataType ids, core_convert.cuh).
enum Codec { kWireBf16 = 1, kWireFp16 = 2, kWireInt8 = 3 };
// ReduceOp values of core/src/common.h; kCopy overwrites.
enum Op { kAverage = 0, kSum = 1, kAdasum = 2, kMin = 3, kMax = 4,
          kProduct = 5, kCopy = -1 };

__device__ __forceinline__ float ReadScale(const uint8_t* w) {
  return __uint_as_float((uint32_t)w[0] | ((uint32_t)w[1] << 8) |
                         ((uint32_t)w[2] << 16) | ((uint32_t)w[3] << 24));
}

__device__ __forceinline__ void WriteScale(uint8_t* w, float scale) {
  uint32_t bits = __float_as_uint(scale);
  w[0] = (uint8_t)bits;
  w[1] = (uint8_t)(bits >> 8);
  w[2] = (uint8_t)(bits >> 16);
  w[3] = (uint8_t)(bits >> 24);
}

// codec.cc: scale = maxabs > 0 ? maxabs / 127 : 1 (a NaN maxabs takes 1).
__device__ __forceinline__ float ScaleOf(float maxabs) {
  return maxabs > 0.0f ? __fdiv_rn(maxabs, 127.0f) : 1.0f;
}

// codec.cc: q = lrintf(std::max(-127, std::min(127, v * inv))).
__device__ __forceinline__ int8_t Quantize(float v, float inv) {
  float s = __fmul_rn(v, inv);
  float m = s < 127.0f ? s : 127.0f;
  float c = -127.0f < m ? m : -127.0f;
  return (int8_t)__float2int_rn(c);
}

// codec.h FloatToHalf by the card's conversion. Rounding toward zero is the
// core's truncation for every |x| below 65536 (fp32 exponent field below
// 143), subnormal halves and signed zeros included. From there up the core
// gives an infinity, where the conversion saturates to 65504, and a NaN
// becomes an infinity of its sign, where the conversion keeps a NaN.
__device__ __forceinline__ uint16_t FloatToHalfCvt(float v) {
  uint32_t f = __float_as_uint(v);
  if (((f >> 23) & 0xff) >= 143)
    return (uint16_t)(((f >> 16) & 0x8000) | 0x7c00);
  return __half_as_ushort(__float2half_rz(v));
}

// codec.h HalfToFloat by the card's conversion, exact for every finite
// half, subnormals included. The core keeps a NaN's payload bits
// (sign | 0x7f800000 | mant << 13), which the conversion need not: the
// halves with an all-ones exponent take the core's bits.
__device__ __forceinline__ float HalfToFloatCvt(uint16_t h) {
  if ((h & 0x7c00) == 0x7c00)
    return __uint_as_float(((uint32_t)(h & 0x8000) << 16) | 0x7f800000u |
                           ((uint32_t)(h & 0x3ff) << 13));
  return __half2float(__ushort_as_half(h));
}

// The wire's element type: 16 bits for bf16 and fp16, a signed byte after
// the 4-byte scale for int8.
template <int C> struct WireOf { typedef uint16_t T; };
template <> struct WireOf<kWireInt8> { typedef int8_t T; };

template <int C>
__device__ __forceinline__ typename WireOf<C>::T* WireElems(uint8_t* wire) {
  return (typename WireOf<C>::T*)(wire + (C == kWireInt8 ? 4 : 0));
}

template <int C>
__device__ __forceinline__ const typename WireOf<C>::T* WireElems(
    const uint8_t* wire) {
  return (const typename WireOf<C>::T*)(wire + (C == kWireInt8 ? 4 : 0));
}

// V values of T in one aligned access (16, 8 or 4 bytes of fp32; 8, 4 or 2
// of bf16/fp16; 4, 2 or 1 of int8).
template <typename T, int V> struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <int C>
__device__ __forceinline__ typename WireOf<C>::T EncodeOne(float v,
                                                           float inv) {
  if (C == kWireInt8) return (typename WireOf<C>::T)Quantize(v, inv);
  if (C == kWireBf16) return (typename WireOf<C>::T)FloatToBf16(v);
  return (typename WireOf<C>::T)FloatToHalfCvt(v);
}

template <int C>
__device__ __forceinline__ float DecodeOne(typename WireOf<C>::T w,
                                           float scale) {
  if (C == kWireInt8) return __fmul_rn((float)(int8_t)w, scale);
  if (C == kWireBf16) return Bf16ToFloat((uint16_t)w);
  return HalfToFloatCvt((uint16_t)w);
}

template <int OP>
__device__ __forceinline__ float Combine(float a, float d) {
  switch (OP) {
    case kMin: return d < a ? d : a;
    case kMax: return a < d ? d : a;
    case kProduct: return __fmul_rn(a, d);
    case kCopy: return d;
    default: return __fadd_rn(a, d);
  }
}

// The elements before the fp32 side's first V-aligned one (at most count).
template <int V>
__device__ __forceinline__ long long HeadOf(const float* p, long long count) {
  long long h = (V - (long long)(((uintptr_t)p >> 2) % V)) % V;
  return h < count ? h : count;
}

// The element of the scalar head or tail that thread t of block 0 takes
// (threads [0, V - 1) the head, [V - 1, 2V - 2) the tail), or -1.
template <int V>
__device__ __forceinline__ long long EdgeOf(int t, long long head,
                                            long long nvec,
                                            long long count) {
  if (t < V - 1) return t < head ? t : -1;
  long long i = head + nvec * V + (t - (V - 1));
  return t < 2 * (V - 1) && i < count ? i : -1;
}

// --- encode ------------------------------------------------------------------

// wire = encode(src[0, count)); int8 reads its scale from the wire, written
// there by EncodeMaxKernel.
template <int C, int V>
__global__ void __launch_bounds__(kThreads)
    EncodeKernel(const float* __restrict__ src, long long count,
                 uint8_t* __restrict__ wire) {
  typedef typename WireOf<C>::T W;
  float inv = C == kWireInt8 ? __fdiv_rn(1.0f, ReadScale(wire)) : 0.0f;
  W* out = WireElems<C>(wire);
  long long head = HeadOf<V>(src, count);
  long long nvec = (count - head) / V;
  const Vec<float, V>* in = (const Vec<float, V>*)(src + head);
  Vec<W, V>* o = (Vec<W, V>*)(out + head);
  long long stride = (long long)gridDim.x * kThreads;
  for (long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
       j < nvec; j += kUnroll * stride) {
    Vec<float, V> a[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (j + u * stride < nvec) a[u] = in[j + u * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j + u * stride < nvec) {
        Vec<W, V> b;
#pragma unroll
        for (int e = 0; e < V; ++e) b.v[e] = EncodeOne<C>(a[u].v[e], inv);
        o[j + u * stride] = b;
      }
    }
  }
  if (blockIdx.x == 0) {
    long long i = EdgeOf<V>(threadIdx.x, head, nvec, count);
    if (i >= 0) out[i] = EncodeOne<C>(src[i], inv);
  }
}

template <typename T>
__device__ __forceinline__ T BlockMax(T v, T* shared) {
  for (int d = 16; d > 0; d >>= 1) {
    T o = __shfl_down_sync(kFull, v, d);
    v = o > v ? o : v;
  }
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) v = shared[w] > v ? shared[w] : v;
    shared[0] = v;
  }
  __syncthreads();
  v = shared[0];
  __syncthreads();
  return v;
}

// One element of the max pass: a NaN moves the chunk's last NaN, any other
// value the largest |x|.
__device__ __forceinline__ void TakeMax(float v, long long i,
                                        long long& nan, float& m) {
  if (isnan(v))
    nan = i > nan ? i : nan;
  else
    m = fabsf(v) > m ? fabsf(v) : m;
}

// The in-order merge of two partials, `later` after `*earlier`: a NaN in
// the later one restarts the max after it.
__device__ __forceinline__ void MergeInto(long long& nan, float& m,
                                          long long later_nan,
                                          float later_m) {
  if (later_nan >= 0) {
    nan = later_nan;
    m = later_m;
  } else {
    m = later_m > m ? later_m : m;
  }
}

// The lanes' partials merged in lane order, into lane 0.
__device__ __forceinline__ void WarpMerge(long long& nan, float& m) {
  int lane = threadIdx.x & 31;
  for (int d = 1; d < 32; d <<= 1) {
    long long o_nan = __shfl_down_sync(kFull, nan, d);
    float o_m = __shfl_down_sync(kFull, m, d);
    if ((lane & (2 * d - 1)) == 0) MergeInto(nan, m, o_nan, o_m);
  }
}

// codec.cc's maxabs of a merged partial: NaN if the last NaN has nothing
// after it, else the max after it (0 for no element).
__device__ __forceinline__ float MaxabsOf(long long nan, float m) {
  if (nan >= 0 && m < 0.0f) return __int_as_float(0x7fffffff);
  return m < 0.0f ? 0.0f : m;
}

// The whole block merges partials [0, chunks) in index order: each thread
// a contiguous run, then the warps' lanes and the warps in order. Returns
// codec.cc's maxabs on thread 0: NaN if the last NaN has nothing after it,
// else the max after it. The partials come from other blocks: they are
// read past L1.
__device__ float BlockMergedMaxabs(const long long* nans, const float* maxes,
                                   long long chunks) {
  __shared__ long long s_nan[kWarps];
  __shared__ float s_max[kWarps];
  long long per = (chunks + kThreads - 1) / kThreads;
  long long lo = threadIdx.x * per;
  long long hi = lo + per < chunks ? lo + per : chunks;
  long long nan = -1;
  float m = -1.0f;
  for (long long c = lo; c < hi; ++c)
    MergeInto(nan, m, __ldcg(nans + c), __ldcg(maxes + c));
  WarpMerge(nan, m);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_nan[warp] = nan;
    s_max[warp] = m;
  }
  __syncthreads();
  float maxabs = 0.0f;
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) MergeInto(nan, m, s_nan[w], s_max[w]);
    maxabs = MaxabsOf(nan, m);
  }
  return maxabs;
}

// The chunks of the max pass: chunk 0 is [0, head + kEncodeChunk), chunk
// c > 0 is [head + c kEncodeChunk, head + (c + 1) kEncodeChunk), all cut
// at count; so every chunk but the first starts on a 16-byte boundary.
long long EncodeChunksOf(const float* src, long long count) {
  long long head = (4 - (long long)(((uintptr_t)src >> 2) & 3)) & 3;
  head = head < count ? head : count;
  long long chunks = (count - head + kEncodeChunk - 1) / kEncodeChunk;
  return chunks > 0 ? chunks : 1;
}

// One block per chunk: the chunk's partial; the last block to finish
// merges them all and writes the scale into wire[0, 4). `counter` is 0
// when the launch starts and when it ends.
__global__ void __launch_bounds__(kThreads)
    EncodeMaxKernel(const float* __restrict__ src, long long count,
                    long long* __restrict__ nans, float* __restrict__ maxes,
                    unsigned* __restrict__ counter,
                    uint8_t* __restrict__ wire) {
  __shared__ long long s_nan[kWarps];
  __shared__ float s_max[kWarps];
  __shared__ bool s_last;
  long long head = HeadOf<4>(src, count);
  long long c = blockIdx.x;
  long long begin = c == 0 ? 0 : head + c * kEncodeChunk;
  long long vbegin = c == 0 ? head : begin;
  long long end = head + (c + 1) * kEncodeChunk;
  end = end < count ? end : count;
  long long nvec = (end - vbegin) / 4;
  long long vend = vbegin + 4 * nvec;
  const float4* in = (const float4*)(src + vbegin);
  long long nan = -1;
  float m = -1.0f;
  for (long long j = threadIdx.x; j < nvec; j += kUnroll * kThreads) {
    float4 a[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (j + u * kThreads < nvec) a[u] = in[j + u * kThreads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j + u * kThreads < nvec) {
        long long i = vbegin + 4 * (j + u * kThreads);
        TakeMax(a[u].x, i, nan, m);
        TakeMax(a[u].y, i + 1, nan, m);
        TakeMax(a[u].z, i + 2, nan, m);
        TakeMax(a[u].w, i + 3, nan, m);
      }
    }
  }
  // The scalar head (chunk 0 only) and tail (the last chunk only).
  if (threadIdx.x < 6) {
    long long i = threadIdx.x < 3 ? begin + threadIdx.x
                                  : vend + (threadIdx.x - 3);
    if (threadIdx.x < 3 ? i < vbegin : i < end) TakeMax(src[i], i, nan, m);
  }
  nan = BlockMax(nan, s_nan);
  if (nan >= 0) {  // uniform over the block: the max after the last NaN
    m = -1.0f;
    for (long long i = nan + 1 + threadIdx.x; i < end; i += kThreads) {
      float a = fabsf(src[i]);
      m = a > m ? a : m;
    }
  }
  m = BlockMax(m, s_max);
  if (threadIdx.x == 0) {
    nans[c] = nan;
    maxes[c] = m;
    // The partial is visible to every block before the count says so.
    __threadfence();
    s_last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  float maxabs = BlockMergedMaxabs(nans, maxes, gridDim.x);
  if (threadIdx.x == 0) {
    WriteScale(wire, ScaleOf(maxabs));
    // Every block has counted: none reads the counter again in this
    // launch, and the next launch on the stream starts after this store.
    *counter = 0u;
  }
}

// --- decode and reduce -------------------------------------------------------

template <int C, int OP, int V>
__global__ void __launch_bounds__(kThreads)
    DecodeReduceKernel(const uint8_t* __restrict__ wire, long long count,
                       float* __restrict__ dst) {
  typedef typename WireOf<C>::T W;
  float scale = C == kWireInt8 ? ReadScale(wire) : 0.0f;
  const W* w = WireElems<C>(wire);
  long long head = HeadOf<V>(dst, count);
  long long nvec = (count - head) / V;
  const Vec<W, V>* win = (const Vec<W, V>*)(w + head);
  Vec<float, V>* d = (Vec<float, V>*)(dst + head);
  long long stride = (long long)gridDim.x * kThreads;
  for (long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
       j < nvec; j += kUnroll * stride) {
    Vec<W, V> a[kUnroll];
    Vec<float, V> b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j + u * stride < nvec) {
        a[u] = win[j + u * stride];
        if (OP != kCopy) b[u] = d[j + u * stride];  // the copy only writes
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j + u * stride < nvec) {
        Vec<float, V> r;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          float x = DecodeOne<C>(a[u].v[e], scale);
          r.v[e] = OP == kCopy ? x : Combine<OP>(b[u].v[e], x);
        }
        d[j + u * stride] = r;
      }
    }
  }
  if (blockIdx.x == 0) {
    long long i = EdgeOf<V>(threadIdx.x, head, nvec, count);
    if (i >= 0) {
      float x = DecodeOne<C>(w[i], scale);
      dst[i] = OP == kCopy ? x : Combine<OP>(dst[i], x);
    }
  }
}

// --- error feedback ----------------------------------------------------------

// The value a thread reads: x, or x + r for the error feedback.
__device__ __forceinline__ float Load(const float* x, const float* r,
                                      long long i) {
  return r ? __fadd_rn(x[i], r[i]) : x[i];
}

// The partial of elements [begin, end): the index of their last NaN (-1 if
// none) and the largest |value| after it (-1 if nothing follows it).
__device__ void ChunkMax(const float* x, const float* r, long long begin,
                         long long end, long long* nan_out,
                         float* max_out) {
  __shared__ long long s_nan[kWarps];
  __shared__ float s_max[kWarps];
  long long nan = -1;
  float m = -1.0f;
  for (long long i = begin + threadIdx.x; i < end; i += kThreads) {
    float v = Load(x, r, i);
    if (isnan(v))
      nan = i;
    else
      m = fabsf(v) > m ? fabsf(v) : m;
  }
  nan = BlockMax(nan, s_nan);
  if (nan >= 0) {  // uniform over the block: the max after the last NaN
    m = -1.0f;
    for (long long i = nan + 1 + threadIdx.x; i < end; i += kThreads) {
      float a = fabsf(Load(x, r, i));
      m = a > m ? a : m;
    }
  }
  m = BlockMax(m, s_max);
  if (threadIdx.x == 0) {
    *nan_out = nan;
    *max_out = m;
  }
}

// One warp: chunks [first, first + chunks) merged in index order, then
// codec.cc's maxabs: NaN if the last NaN has nothing after it, else the max
// after it (0 for no element).
__device__ float MergedMaxabs(const long long* nans, const float* maxes,
                              long long first, long long chunks) {
  int lane = threadIdx.x;
  long long per = (chunks + 31) / 32;
  long long lo = first + lane * per;
  long long hi = lo + per < first + chunks ? lo + per : first + chunks;
  long long nan = -1;
  float m = -1.0f;
  for (long long c = lo; c < hi; ++c) MergeInto(nan, m, nans[c], maxes[c]);
  WarpMerge(nan, m);
  return MaxabsOf(nan, m);
}

// Table rows: x pointer, r pointer, count, first chunk; sorted by first
// chunk, no row of count 0.
__device__ int SegmentOf(const long long* table, int n, long long chunk) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (table[4 * mid + 3] <= chunk)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
    FeedbackMaxKernel(const long long* __restrict__ table, int n_segments,
                      long long* __restrict__ nans,
                      float* __restrict__ maxes) {
  long long chunk = blockIdx.x;
  int s = SegmentOf(table, n_segments, chunk);
  const float* x = (const float*)table[4 * s];
  const float* r = (const float*)table[4 * s + 1];
  long long count = table[4 * s + 2];
  long long begin = (chunk - table[4 * s + 3]) * kChunk;
  long long end = begin + kChunk < count ? begin + kChunk : count;
  ChunkMax(x, r, begin, end, nans + chunk, maxes + chunk);
}

__global__ void __launch_bounds__(32)
    FeedbackScaleKernel(const long long* __restrict__ table,
                        const long long* __restrict__ nans,
                        const float* __restrict__ maxes,
                        float* __restrict__ scales) {
  int s = blockIdx.x;
  long long count = table[4 * s + 2];
  float maxabs = MergedMaxabs(nans, maxes, table[4 * s + 3],
                              (count + kChunk - 1) / kChunk);
  if (threadIdx.x == 0) scales[s] = ScaleOf(maxabs);
}

__global__ void __launch_bounds__(kThreads)
    FeedbackApplyKernel(const long long* __restrict__ table, int n_segments,
                        const float* __restrict__ scales) {
  long long chunk = blockIdx.x;
  int s = SegmentOf(table, n_segments, chunk);
  float* x = (float*)table[4 * s];
  float* r = (float*)table[4 * s + 1];
  long long count = table[4 * s + 2];
  long long begin = (chunk - table[4 * s + 3]) * kChunk;
  long long end = begin + kChunk < count ? begin + kChunk : count;
  float scale = scales[s];
  float inv = __fdiv_rn(1.0f, scale);
  for (long long i = begin + threadIdx.x; i < end; i += kThreads) {
    float v = __fadd_rn(x[i], r[i]);
    float xq = __fmul_rn((float)Quantize(v, inv), scale);
    r[i] = __fsub_rn(v, xq);
    x[i] = xq;
  }
}

// --- launches ----------------------------------------------------------------

// The widest access, in values, that both sides allow: fp32 at `f32`, wire
// elements of `size` bytes at `elems`, at the same element index.
int VecOf(const void* f32, const void* elems, int size) {
  long long pf = (long long)(((uintptr_t)f32 >> 2) & 3);
  long long pw = (long long)(((uintptr_t)elems / size) & 3);
  if (pf == pw) return 4;
  return (pf & 1) == (pw & 1) ? 2 : 1;
}

// Enough blocks for one thread per access, at most kBlocksPerSm on every
// SM: the threads stride over the rest.
unsigned GridOf(long long count, int v) {
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  long long blocks = (count / v + kThreads) / kThreads;
  long long cap = (long long)sms * kBlocksPerSm;
  return (unsigned)(blocks < cap ? blocks : cap);
}

template <int C>
cudaError_t LaunchEncode(const float* src, long long count, uint8_t* wire,
                         cudaStream_t st) {
  const uint8_t* elems = wire + (C == kWireInt8 ? 4 : 0);
  int v = VecOf(src, elems, C == kWireInt8 ? 1 : 2);
  unsigned grid = GridOf(count, v);
  if (v == 4)
    EncodeKernel<C, 4><<<grid, kThreads, 0, st>>>(src, count, wire);
  else if (v == 2)
    EncodeKernel<C, 2><<<grid, kThreads, 0, st>>>(src, count, wire);
  else
    EncodeKernel<C, 1><<<grid, kThreads, 0, st>>>(src, count, wire);
  return cudaGetLastError();
}

template <int C, int OP>
void LaunchDecodeOp(const uint8_t* wire, long long count, float* dst,
                    cudaStream_t st) {
  const uint8_t* elems = wire + (C == kWireInt8 ? 4 : 0);
  int v = VecOf(dst, elems, C == kWireInt8 ? 1 : 2);
  unsigned grid = GridOf(count, v);
  if (v == 4)
    DecodeReduceKernel<C, OP, 4><<<grid, kThreads, 0, st>>>(wire, count,
                                                            dst);
  else if (v == 2)
    DecodeReduceKernel<C, OP, 2><<<grid, kThreads, 0, st>>>(wire, count,
                                                            dst);
  else
    DecodeReduceKernel<C, OP, 1><<<grid, kThreads, 0, st>>>(wire, count,
                                                            dst);
}

template <int C>
cudaError_t LaunchDecode(const uint8_t* wire, long long count, float* dst,
                         int op, cudaStream_t st) {
  switch (op) {
    case kAverage:
    case kAdasum:
    case kSum:
      LaunchDecodeOp<C, kSum>(wire, count, dst, st);
      break;
    case kMin:
      LaunchDecodeOp<C, kMin>(wire, count, dst, st);
      break;
    case kMax:
      LaunchDecodeOp<C, kMax>(wire, count, dst, st);
      break;
    case kProduct:
      LaunchDecodeOp<C, kProduct>(wire, count, dst, st);
      break;
    case kCopy:
      LaunchDecodeOp<C, kCopy>(wire, count, dst, st);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Encode src[0..count) into wire (CodecWireBytes(codec, count) bytes; 2-byte
// aligned for bf16 and fp16; src 4-byte aligned). int8 uses `scratch`
// (12 bytes per kEncodeChunk values, 8-byte aligned) and `counter`, a device
// unsigned that is 0 and that no other launch uses meanwhile: one counter
// per stream. bf16 and fp16 are one launch on `stream`, int8 two; returns
// the last cudaError_t.
//
// The counter is 0 again when the max pass ends: its last block sets it
// back. A launch that is refused (its error is returned here) never ran
// and left it at 0. A fault inside a running kernel is sticky: it fails
// every later call in the process, and the counter is never read again.
int hvd_codec_encode(int codec, const float* src, long long count,
                     uint8_t* wire, void* scratch, unsigned* counter,
                     void* stream) {
  if (count <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (codec == kWireBf16)
    return (int)LaunchEncode<kWireBf16>(src, count, wire, st);
  if (codec == kWireFp16)
    return (int)LaunchEncode<kWireFp16>(src, count, wire, st);
  if (codec != kWireInt8) return (int)cudaErrorInvalidValue;
  long long chunks = EncodeChunksOf(src, count);
  if (chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  long long* nans = (long long*)scratch;
  float* maxes = (float*)(nans + chunks);
  EncodeMaxKernel<<<(unsigned)chunks, kThreads, 0, st>>>(src, count, nans,
                                                        maxes, counter,
                                                        wire);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)LaunchEncode<kWireInt8>(src, count, wire, st);
}

// dst[i] = op(dst[i], decode(wire, i)) for i < count; op is a ReduceOp of
// core/src/common.h (Average and Adasum sum) or -1 to overwrite, which
// reads no dst. dst 4-byte aligned. One launch.
int hvd_codec_decode_reduce(int codec, const uint8_t* wire, long long count,
                            float* dst, int op, void* stream) {
  if (count <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (codec) {
    case kWireBf16:
      return (int)LaunchDecode<kWireBf16>(wire, count, dst, op, st);
    case kWireFp16:
      return (int)LaunchDecode<kWireFp16>(wire, count, dst, op, st);
    case kWireInt8:
      return (int)LaunchDecode<kWireInt8>(wire, count, dst, op, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The int8 feedback of every row of `table` (device memory, n_segments rows
// of x pointer, r pointer, count, first chunk; n_chunks chunks in all), in
// place on x and r. `scratch`: 12 bytes per chunk and 4 per row, 8-byte
// aligned. Three launches on `stream`.
int hvd_codec_error_feedback(const long long* table, int n_segments,
                             long long n_chunks, void* scratch,
                             void* stream) {
  if (n_segments <= 0 || n_chunks <= 0) return 0;
  if (n_chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  long long* nans = (long long*)scratch;
  float* maxes = (float*)(nans + n_chunks);
  float* scales = maxes + n_chunks;
  FeedbackMaxKernel<<<(unsigned)n_chunks, kThreads, 0, st>>>(
      table, n_segments, nans, maxes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  FeedbackScaleKernel<<<n_segments, 32, 0, st>>>(table, nans, maxes, scales);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  FeedbackApplyKernel<<<(unsigned)n_chunks, kThreads, 0, st>>>(
      table, n_segments, scales);
  return (int)cudaGetLastError();
}

}  // extern "C"
