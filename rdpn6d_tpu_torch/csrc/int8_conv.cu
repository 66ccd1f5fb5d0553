// int8_conv: the W8A8 convolution of int8 serving, in three entry points.
//
//  * quantize: activations x, NCHW bfloat16 or float32 [B,C,H,W] -> xq, NHWC
//    int8 [B,H,W,Cp] with the channels zero-padded to Cp (a multiple of 32),
//    and the scale sx [B] float32. The scale is per sample (dynamic: the
//    absmax of the sample over C, H and W), a static calibrated scalar, or
//    the static scalar of the SmoothQuant-balanced activation (per-channel:
//    x is divided by t[c] * s).
//  * bn_relu_quantize: the same, of relu(bn(y)) with an optional skip
//    appended on the channel axis: y [B,C1,H,W] is the input of an eval
//    BatchNorm folded into float32 constants mean, mul and bias [C1]; skip
//    [B,C2,H,W] (no BN, no ReLU) follows as channels C1 .. C1 + C2 - 1.
//    One pass where the head ran a BN, a ReLU, a concat and quantize.
//  * conv: xq ⊛ wq, with wq int8 [N][kh][kw][Cp] (scale sw [N] per output
//    channel), int32 accumulation, dequantized to out [B,N,Ho,Wo] NCHW in
//    bfloat16 or float32.
//
// Replaces rdpn6d_tpu/models/quant.py:42 Int8Conv (its quantization, :32
// quantize_symmetric and :103-155; the int32-accumulating XLA convolution,
// :131-133 and :146-148). Not a Pallas kernel: on the TPU it is an XLA int8
// convolution on the MXU. bn_relu_quantize is what XLA makes of the head's
// BN -> relu -> concatenate -> static requantize (rdpn6d_tpu/models/
// heads.py:70-84, quant.py:127 and :140): one elementwise fusion, which
// quant.py:47-55 names as the static mode's gain.
//
// Arithmetic, op for op as the JAX package and the plain version
// (ops/int8_conv.py) compute it, so that all three agree bit for bit:
//  * s = max(amax, 1e-12) / 127 in float32 (__fdiv_rn);
//  * the folded BN (flax's _normalize order, as XLA's CPU build computes
//    it): z = fma(y - mean[c], mul[c], bias[c]) in float32 (__fsub_rn,
//    then __fmaf_rn: one rounding), rounded to the model's dtype
//    (__float2bfloat16_rn under bfloat16), then relu keeping NaN as
//    jnp.maximum does (max.NaN.f32; fmaxf drops it); a skip channel is
//    taken as it is;
//  * q = clip(rint(x / d), -127, 127) with d = s, or d = t[c] * s
//    (__fmul_rn, the product first, as quant.py:127), x / d correctly
//    rounded (from d's correctly rounded reciprocal and two FMAs; see
//    quant()), rounded half to even as jnp.round does (cvt.rni);
//  * y = float(acc) * (sx[b] * sw[n]) (the product first, quant.py:149-150
//    and :134), __int2float_rn and __fmul_rn, then __float2bfloat16_rn for
//    bfloat16 output. The build has no --use_fast_math.
//  * NaN as in XLA: a NaN in a sample makes its dynamic absmax, scale and
//    so its whole output NaN (jnp.max propagates it), and a NaN x / d
//    quantizes to 0 (XLA converts NaN to integer 0).
// The int32 sum is exact in any order: |acc| <= 127^2 * K, 4.6e7 at the
// largest K (2880) of the head, far from overflow.
//
// Bound of the quantizers: bytes. x (or y and skip) read once, xq written
// once: at B = 16, 64 x 64, bf16, 256 channels 0.0150 ms and 256 BN'd +
// 64 skip channels 0.0188 ms at 3.35 TB/s; a divide, a round and an FMA an
// element are far below the card's rate.
//
// Bound of the conv, the lm13 head at the serving batch of 16 (M = 16 x
// 64 x 64 output pixels, N = 256): operations. 2 M N K int8 operations over 1,979 TOP/s
// dense (H100 SXM): K = 2880 (320 input channels, the first conv after the
// rot_concat skip) 96.6 GOP = 48.8 us; K = 2304 (256 -> 256) 77.3 GOP =
// 39.1 us. The bytes (xq and wq read once, bf16 out written once) take
// ~16 us at 3.35 TB/s either way.
//
// Design (simple and right first; TMA, a staged halo, warp specialisation
// and persistent tiles are later work):
//  * Implicit GEMM: M = B Ho Wo rows, N = Cout columns, K = kh kw Cp. A is
//    the im2col of the NHWC xq and B is wq [N][K]: both K-major, the only
//    layout wgmma takes for 8-bit operands.
//  * A block of 256 threads, two warpgroups, owns a 128 x BN output tile
//    (BN 256, 128 or 64 and the stage count from ops/int8_conv.py's
//    int8_conv_plan, passed in and checked); each warpgroup issues
//    wgmma.mma_async.m64nBNk32.s32.s8.s8 on its 64 rows with both operands
//    in shared memory, BN / 2 int32 accumulators a thread.
//  * K goes in slabs of 128 bytes (four k32 wgmmas) through a ring of
//    kStages buffers in dynamic shared memory, filled by cp.async from all
//    256 threads. Each 16-byte chunk has its own tap and channel, advanced
//    from its k offset slab by slab (Cp is a multiple of 32, so no chunk
//    straddles a tap); a tap in the padding, a row past M or N and a chunk
//    past K are zero-filled by cp.async's src-size 0. The loader's work
//    sits between two barriers, so it is kept short: each A row's origin
//    in xq is computed once, a slab adds one tap offset and tests two
//    bounds a row.
//  * Shared layout: wgmma's canonical K-major layout with the 128-byte
//    swizzle: tile row r's 128 bytes of the slab at r 128, its 16-byte
//    chunk c at (c ^ r % 8) 16, so the eight rows of an 8-row group put a
//    chunk on eight distinct bank quarters. The descriptor's stride byte
//    offset (SBO) steps between 8-row groups; a k32 step moves its start
//    address by 32 bytes (PTX ISA, "Matrix Descriptor Format").
//    tests/test_torch_int8_plan.py places the chunks and reads them back
//    through these constants in numpy. Without a swizzle (core matrices of
//    8 x 16 bytes, 128 bytes apart along K) wgmma's reads fall on the same
//    banks. A warp's 32 chunks fill 512 contiguous bytes: no bank
//    conflicts on the copies.
//  * A slab: cp.async.wait_group; fence.proxy.async (cp.async writes
//    through the generic proxy, wgmma reads through the async proxy);
//    __syncthreads; the slab's wgmmas, committed as one group; the copies
//    of the slab kStages - 2 ahead, into the buffer of slab kt - 2, whose
//    wgmmas every warpgroup waited for before the barrier; then
//    wgmma.wait_group 1, so one slab's wgmmas run under the next slab's
//    wait and barrier. The fence waits for the thread's copies in flight
//    too; a 128-byte slab holds enough tensor work to cover that.
//  * Epilogue: the accumulators go through shared memory (the ring is free
//    by then), 64 channels at a time, so that a warp stores 32 consecutive
//    pixels of one channel at once (64 bytes of bfloat16) where the direct
//    stores of the wgmma fragment used half of each 32-byte sector. A tile
//    that crosses a sample or passes N is masked.
//  * Traffic from L2, the 320 -> 256 head conv at 128 x 256 tiles: each
//    block reads its A rows and all of B once per slab, ~0.57 GB in all.
//  * The quantizers are one kernel template (quantize_kernel; the folded
//    BN is a compile-time prologue). A block owns a tile, kQPix
//    consecutive pixels (h W + w) of one sample, and walks its channels
//    kQCh at a time: each stage, kQCh channel rows of kQPix pixels, comes
//    by 16-byte cp.async copies (8 bf16 pixels a copy) into a ring of
//    kQStages buffers, so three stages are in flight while one is
//    quantized. The rows land XOR-swizzled: 16-byte chunk j of channel row
//    ch at chunk j ^ (ch >> kQSwzShift & kQSwzMask). A thread quantizes 4
//    channels x 2 pixels of a stage (a 32- or 64-bit shared read a
//    channel; the swizzle puts a warp's reads on 32 distinct banks) and
//    packs each pixel's 4 channels into one word of an out tile
//    [kQPix][Cp + kQPad] in shared memory (the padding puts a warp's word
//    stores on distinct banks). The tile's xq, kQPix x Cp contiguous
//    bytes, then leaves in 16-byte stores. The BN constants, and each
//    channel's divisor and its reciprocal, sit in shared memory; x / d
//    takes the reciprocal and two FMAs (quant()), not a division. Where
//    H W is not a multiple of 8 bf16 (4 float32) pixels, or a pointer is
//    not 16-byte aligned, the rows come by scalar loads through the same
//    layout. tests/test_torch_fused_quant.py emulates the layout and the
//    thread map in numpy with these constants.
//  * The dynamic mode first reduces each sample's absmax, prologue
//    applied, over blocks (whole channel planes a block) into an unsigned
//    word by atomicMax (16-byte loads): |x| orders as its bits, and a
//    NaN's bits order above every other value's, so the max propagates
//    NaN. At the head (33.5 MB of
//    bf16 at B = 16, 256 channels) the second read finds the activation
//    in the 50 MB L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int kCinAlign = 32;     // channel padding of xq and wq: one k-tile
// quantize
constexpr int kQPix = 64;         // pixels (h W + w, one sample) a block
constexpr int kQCh = 32;          // channels a stage: one k-tile of xq
constexpr int kQStages = 4;       // the ring along channels
constexpr int kQThreads = 256;
constexpr int kQPad = 16;         // bytes past Cp a pixel row of the out tile
constexpr int kQSwzShift = 2;     // the input rows' swizzle (see above)
constexpr int kQSwzMask = 7;
constexpr int kSmemLimit = 232448;   // dynamic shared memory a block may use
constexpr int kAmaxThreads = 256;
constexpr int kAmaxMaxBlocks = 64;   // blocks a sample's absmax at most
// conv
constexpr int kBM = 128;          // tile rows: two warpgroups of 64
constexpr int kBK = 128;          // bytes of K a stage holds: a slab
constexpr int kKStep = 32;        // bytes of K one wgmma takes
constexpr int kConvThreads = 256;
constexpr int kChunk = 16;        // bytes a cp.async copies
// the shared layout wgmma reads: K-major rows of kBK bytes with the
// 128-byte swizzle (descriptor layout type 1; chunk c of row r at r kBK +
// (c ^ r % 8) 16), 8-row groups kSBO apart; LBO is unused by a swizzled
// K-major operand (1, as CUTLASS sets it)
constexpr int kLayoutType = 1;
constexpr int kLBO = 16;
constexpr int kSBO = 8 * kBK;
constexpr int kEpiChannels = 64;  // channels a pass of the staged epilogue
constexpr int kEpiPitch = kBM + 4;          // int32 a staged channel row
// the launch plans implemented, (BN, stages): one ring depth for each tile
// width (ops/int8_conv.STAGES); 128 wide, two blocks share an SM
#define INT8_CONV_PLANS(X) X(256, 4) X(128, 3) X(64, 4)

enum Mode { kDynamic = 0, kStatic = 1, kPerChannel = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp_async16(uint32_t smem, const void* gmem,
                                           bool pred) {
  const int n = pred ? 16 : 0;   // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------- quantize

// What a quantizer reads: y [B,C1,P] (P = H W) in T, for bn_relu_quantize
// the folded BN's input; skip [B,C2,P] in T or none (C2 = 0); mean, mul,
// bias [C1] (BN only); amax [1] (static modes) or the bits of [B] absmaxes
// (dynamic); t [C1 + C2] (per channel). Writes xq [B,P,Cp] and sx [B].
struct QuantArgs {
  const void* y;
  const void* skip;
  const float* mean;
  const float* mul;
  const float* bias;
  const float* amax;
  const float* t;
  int8_t* xq;
  float* sx;
  int C1, C2, P, Cp;
};

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The value quantized for an element v of a channel: relu(bn(v)) rounded
// to T where the channel is BN'd (bn), else v itself.
template <typename T, bool kBN>
__device__ __forceinline__ float prologue(float v, bool bn, float mean,
                                          float mul, float bias) {
  if (!kBN || !bn) return v;
  const float z = round_to<T>(__fmaf_rn(__fsub_rn(v, mean), mul, bias));
  float r;   // relu keeping NaN, as jnp.maximum (fmaxf drops it)
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(z), "f"(0.f));
  return r;
}

// clip(rint(v / d), -127, 127), NaN to 0 as XLA converts it. v / d is
// taken correctly rounded, as __fdiv_rn gives it, from r = RN(1 / d): q0 =
// RN(v r) is within an ulp of v / d, the FMA gives the remainder v - q0 d
// exactly, and RN(q0 + rem r) is the correctly rounded quotient
// (Markstein's theorem), where nothing overflows or underflows. An
// underflowing quotient rounds to 0 and an overflowing one clips to ±127
// either way; where q0 is not finite (v infinite, or v / d past the float
// range) the remainder would be NaN, and q0 is the quotient's own value.
__device__ __forceinline__ uint32_t quant(float v, float d, float r) {
  const float q0 = __fmul_rn(v, r);
  const float q =
      isfinite(q0) ? __fmaf_rn(__fmaf_rn(-q0, d, v), r, q0) : q0;
  // cvt.rni: half to even as jnp.round, NaN to 0 and saturating, as XLA
  // converts; then the clip
  const int i = __float2int_rn(q);
  return (uint32_t)(uint8_t)(int8_t)min(max(i, -127), 127);
}

// the chunk where 16-byte chunk j of a stage's channel row ch lands
__device__ __forceinline__ int swz(int j, int ch) {
  return j ^ ((ch >> kQSwzShift) & kQSwzMask);
}

// Grid (blocks, B): the max of the bits of |prologue(x)| over sample b,
// atomically into amax_bits[b] (zeroed by the caller): the float max, with
// NaN above all. A block walks whole channel planes, blocks apart; kVec:
// 16-byte loads (P a multiple of their elements).
template <typename T, bool kBN, bool kVec>
__global__ void __launch_bounds__(kAmaxThreads)
    absmax_kernel(QuantArgs a, unsigned* __restrict__ amax_bits) {
  constexpr int kV = kVec ? 16 / (int)sizeof(T) : 1;
  const int b = blockIdx.y, C = a.C1 + a.C2, P = a.P;
  unsigned m = 0u;
  for (int c = blockIdx.x; c < C; c += gridDim.x) {
    const bool bn = c < a.C1;
    const T* src = bn ? static_cast<const T*>(a.y) + ((size_t)b * a.C1 + c) * P
                      : static_cast<const T*>(a.skip) +
                            ((size_t)b * a.C2 + c - a.C1) * P;
    float mean = 0.f, mul = 0.f, bias = 0.f;
    if (kBN && bn) {
      mean = __ldg(a.mean + c);
      mul = __ldg(a.mul + c);
      bias = __ldg(a.bias + c);
    }
    for (int p = threadIdx.x * kV; p < P; p += kAmaxThreads * kV) {
      uint4 raw;
      if constexpr (kVec)
        raw = __ldg(reinterpret_cast<const uint4*>(src + p));
      else
        *reinterpret_cast<T*>(&raw) = src[p];
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < kV; ++e)
        m = max(m, __float_as_uint(fabsf(prologue<T, kBN>(
                       to_f32(v[e]), bn, mean, mul, bias))));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ unsigned warp_max[kAmaxThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < kAmaxThreads / 32 ? warp_max[threadIdx.x] : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (threadIdx.x == 0) atomicMax(&amax_bits[b], m);
  }
}

// The shared memory of a quantize block: the ring, the out tile, then the
// BN constants (3 C1 floats) and, per channel, each channel's divisor
// t[c] s and its reciprocal (2 (C1 + C2) floats).
template <typename T>
__host__ __device__ constexpr int quant_stage_bytes() {
  return kQCh * kQPix * (int)sizeof(T);
}
template <typename T>
long long quant_smem(int C1, int C2, int Cp, bool bn, bool per_channel) {
  return (long long)kQStages * quant_stage_bytes<T>() +
         (long long)kQPix * (Cp + kQPad) +
         4LL * ((bn ? 3LL * C1 : 0) + (per_channel ? 2LL * (C1 + C2) : 0));
}

// Block (pixel tile, b): pixels p0 .. p0 + kQPix - 1 of sample b, every
// channel stage (see the design notes at the top).
template <typename T, int kMode, bool kBN, bool kVec>
__global__ void __launch_bounds__(kQThreads)
    quantize_kernel(QuantArgs a) {
  constexpr int kV = 16 / (int)sizeof(T);          // elements a chunk
  constexpr int kRowBytes = kQPix * (int)sizeof(T);
  constexpr int kRowChunks = kRowBytes / 16;
  constexpr int kStageBytes = quant_stage_bytes<T>();
  static_assert(kQThreads == 256 && kQPix == 64 && kQCh == 32,
                "the thread map: 8 warps x 4 pixel pairs x 8 channel quads");
  static_assert(kRowChunks >= kQSwzMask + 1, "the swizzle stays in a row");
  using Bits = typename std::conditional<sizeof(T) == 2, uint16_t,
                                         uint32_t>::type;
  using Pair = typename std::conditional<sizeof(T) == 2, uint32_t,
                                         uint2>::type;
  extern __shared__ __align__(16) uint8_t qsmem[];

  const int tid = threadIdx.x, b = blockIdx.y;
  const int p0 = blockIdx.x * kQPix;
  const int C1 = a.C1, C = a.C1 + a.C2, P = a.P, Cp = a.Cp;
  const int np = min(kQPix, P - p0);
  const int opitch = Cp + kQPad;
  uint8_t* ring = qsmem;
  uint8_t* otile = qsmem + kQStages * kStageBytes;
  float* s_mean = reinterpret_cast<float*>(otile + kQPix * opitch);
  float* s_mul = s_mean + C1;
  float* s_bias = s_mul + C1;
  float* s_d = kBN ? s_bias + C1 : s_mean;   // per channel: t[c] s
  float* s_r = s_d + C;                      // and its reciprocal
  const float am = kMode == kDynamic
                       ? __uint_as_float(reinterpret_cast<const unsigned*>(
                             a.amax)[b])
                       : a.amax[0];
  // max(am, 1e-12) keeping a NaN, as jnp.maximum does (fmaxf drops it)
  const float s = __fdiv_rn(am != am ? am : fmaxf(am, 1e-12f), 127.0f);
  const float rs = __frcp_rn(s);
  if (blockIdx.x == 0 && tid == 0) a.sx[b] = s;
  if (kBN)
    for (int c = tid; c < C1; c += kQThreads) {
      s_mean[c] = a.mean[c];
      s_mul[c] = a.mul[c];
      s_bias[c] = a.bias[c];
    }
  if (kMode == kPerChannel)
    for (int c = tid; c < C; c += kQThreads) {
      s_d[c] = __fmul_rn(a.t[c], s);   // the product first (quant.py:127)
      s_r[c] = __frcp_rn(s_d[c]);
    }

  const T* y = static_cast<const T*>(a.y) + (size_t)b * C1 * P + p0;
  const T* sk = static_cast<const T*>(a.skip) + (size_t)b * a.C2 * P + p0;
  const uint32_t sring =
      static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  // stage st: channel rows st kQCh .. + kQCh - 1 into ring buffer st %
  // kQStages; a row past C or a pixel past P is zero
  auto load = [&](int st) {
    const int buf = (st % kQStages) * kStageBytes, c0 = st * kQCh;
    if constexpr (kVec) {
      for (int i = tid; i < kQCh * kRowChunks; i += kQThreads) {
        const int ch = i / kRowChunks, j = i % kRowChunks, c = c0 + ch;
        const bool ok = c < C && j * kV < np;
        const T* src = !ok      ? y
                       : c < C1 ? y + (size_t)c * P + j * kV
                                : sk + (size_t)(c - C1) * P + j * kV;
        cp_async16(sring + buf + ch * kRowBytes + swz(j, ch) * 16, src, ok);
      }
    } else {
      for (int i = tid; i < kQCh * kQPix; i += kQThreads) {
        const int ch = i / kQPix, px = i % kQPix, c = c0 + ch;
        Bits v = 0;
        if (c < C && px < np)
          v = *reinterpret_cast<const Bits*>(
              c < C1 ? y + (size_t)c * P + px
                     : sk + (size_t)(c - C1) * P + px);
        *reinterpret_cast<Bits*>(ring + buf + ch * kRowBytes +
                                 swz(px / kV, ch) * 16 +
                                 (px % kV) * (int)sizeof(T)) = v;
      }
    }
  };

  // this thread: channels 4 q .. 4 q + 3 of a stage at pixels 2 pp, 2 pp + 1
  const int lane = tid & 31, q = lane & 7, pp = (tid >> 5) * 4 + (lane >> 3);
  const int px = 2 * pp;
  const int nst = Cp / kQCh;
#pragma unroll
  for (int st = 0; st < kQStages - 1; ++st) {
    if (st < nst) load(st);
    cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<kQStages - 2>();   // this thread's copies of stage st
    __syncthreads();                 // everyone's; stage st - 1 read by all
    if (st + kQStages - 1 < nst) load(st + kQStages - 1);
    cp_async_commit();
    const uint8_t* buf = ring + (st % kQStages) * kStageBytes;
    uint32_t word0 = 0u, word1 = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ch = 4 * q + i, c = st * kQCh + ch;
      if (c >= C) continue;           // padding: 0
      const Pair pair = *reinterpret_cast<const Pair*>(
          buf + ch * kRowBytes + swz(px / kV, ch) * 16 +
          (px % kV) * (int)sizeof(T));
      const T* v = reinterpret_cast<const T*>(&pair);
      const bool bn = kBN && c < C1;
      const float mean = bn ? s_mean[c] : 0.f, mul = bn ? s_mul[c] : 0.f,
                  bias = bn ? s_bias[c] : 0.f;
      const float d = kMode == kPerChannel ? s_d[c] : s;
      const float r = kMode == kPerChannel ? s_r[c] : rs;
      word0 |= quant(prologue<T, kBN>(to_f32(v[0]), bn, mean, mul, bias), d,
                     r) << (8 * i);
      word1 |= quant(prologue<T, kBN>(to_f32(v[1]), bn, mean, mul, bias), d,
                     r) << (8 * i);
    }
    uint8_t* o = otile + px * opitch + st * kQCh + 4 * q;
    *reinterpret_cast<uint32_t*>(o) = word0;
    *reinterpret_cast<uint32_t*>(o + opitch) = word1;
  }
  cp_async_wait<0>();
  __syncthreads();
  // the block's xq: np x Cp contiguous bytes, by 16-byte stores
  const int row_chunks = Cp / 16;
  uint4* out = reinterpret_cast<uint4*>(a.xq + ((size_t)b * P + p0) * Cp);
  for (int i = tid; i < np * row_chunks; i += kQThreads) {
    const int p = i / row_chunks, j = i - p * row_chunks;
    out[i] = *reinterpret_cast<const uint4*>(otile + p * opitch + j * 16);
  }
}

// -------------------------------------------------------------------- conv

// cp.async's writes (generic proxy) made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
// keeps the compiler from moving accumulator reads or writes across the
// wgmma fence, commit and wait
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// A shared-memory matrix descriptor (base offset 0: the ring starts on a
// 1024-byte boundary): start address, LBO and SBO, each in 16-byte units,
// and the layout type.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         (uint64_t)(kLBO >> 4) << 16 | (uint64_t)(kSBO >> 4) << 32 |
         (uint64_t)kLayoutType << 62;
}

#define D4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define D16(i) D4(i), D4(i + 4), D4(i + 8), D4(i + 12)
#define D32(i) D16(i), D16(i + 16)
#define D64(i) D32(i), D32(i + 32)
#define D128(i) D64(i), D64(i + 64)

// d += A (64 x 32, descriptor da) B^T (BN x 32, descriptor db), int8 in,
// int32 sums; issued by the 128 threads of a warpgroup together.
template <int BN>
struct Wgmma;

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(int (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}"
        ", %32, %33, p;\n}\n"
        : D32(0)
        : "l"(da), "l"(db), "r"(1));
  }
};
template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(int (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63}"
        ", %64, %65, p;\n}\n"
        : D64(0)
        : "l"(da), "l"(db), "r"(1));
  }
};
template <>
struct Wgmma<256> {
  __device__ __forceinline__ static void mma(int (&d)[128], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
        "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
        "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
        "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
        ", %128, %129, p;\n}\n"
        : D128(0)
        : "l"(da), "l"(db), "r"(1));
  }
};


#undef D4
#undef D16
#undef D32
#undef D64
#undef D128

struct ConvShape {
  int B, H, W, Cp, N, kh, kw, stride, pad, Ho, Wo;
};

// Grid (ceil(M / kBM), ceil(N / BN)); block kConvThreads; dynamic shared
// memory kStages (kBM + BN) kBK bytes.
template <int BN, int kStages, typename TOut>
__global__ void __launch_bounds__(kConvThreads, 1)
    int8_conv_kernel(const int8_t* __restrict__ xq,
                     const float* __restrict__ sx,
                     const int8_t* __restrict__ wq,
                     const float* __restrict__ sw, TOut* __restrict__ out,
                     ConvShape sh) {
  constexpr int kABytes = kBM * kBK;
  constexpr int kStageBytes = (kBM + BN) * kBK;
  constexpr int kChunksRow = kBK / kChunk;               // 4
  constexpr int kRowsPass = kConvThreads / kChunksRow;   // rows a pass: 32
  constexpr int kARows = kBM / kRowsPass;                // A rows a thread
  constexpr int kBRows = BN / kRowsPass;                 // B rows a thread
  constexpr int kPassBytes = kRowsPass / 8 * kSBO;       // a pass's bytes
  static_assert(kStages >= 3, "the ring needs a slab in flight");
  static_assert(kEpiChannels * kEpiPitch * 4 <= kStages * kStageBytes,
                "the staged epilogue reuses the ring");
  extern __shared__ __align__(1024) int8_t smem[];

  const int tid = threadIdx.x;
  const int hw = sh.Ho * sh.Wo;
  const long long M = (long long)sh.B * hw;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int K = sh.kh * sh.kw * sh.Cp;
  const int KT = (K + kBK - 1) / kBK;
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  // the loader: this thread copies chunk kc of tile rows r + kRowsPass i
  // (A and B) to one shared offset within a tile. An A row's origin is the byte
  // offset in xq of its tap (0, 0) at channel 0, off the image where that
  // tap is in the padding; a row past M starts far above the image, so no
  // tap passes the bounds test. A B row past N has no bytes (klim 0).
  const int kc = tid % kChunksRow, r = tid / kChunksRow;
  const uint32_t dst = r * kBK + (kc ^ r % 8) * kChunk;
  long long a_org[kARows];
  int iy0[kARows], ix0[kARows];
#pragma unroll
  for (int i = 0; i < kARows; ++i) {
    const long long m = m0 + r + i * kRowsPass;
    const int b = m < M ? (int)(m / hw) : 0;
    const int p = m < M ? (int)(m - (long long)b * hw) : 0;
    const int oy = p / sh.Wo, ox = p - oy * sh.Wo;
    iy0[i] = oy * sh.stride - sh.pad;
    ix0[i] = ox * sh.stride - sh.pad;
    a_org[i] = (((long long)b * sh.H + iy0[i]) * sh.W + ix0[i]) * sh.Cp;
    if (m >= M) iy0[i] = INT_MIN / 2;
  }
  // its B rows n0 + r + kRowsPass j below N: j < b_rows
  const int8_t* wrow = wq + (size_t)(n0 + r) * K;
  const int b_rows = (sh.N - n0 - r + kRowsPass - 1) / kRowsPass;
  // the chunk's k offset, and its tap (ky, kx) and channel c: advanced by
  // a slab per load, the slabs loaded in order
  int k = kc * kChunk, c = k, kx = 0, ky = 0;
  auto settle = [&] {
    while (c >= sh.Cp) {
      c -= sh.Cp;
      if (++kx == sh.kw) kx = 0, ++ky;
    }
  };
  settle();
  auto load = [&](int stage) {
    const uint32_t a = sbase + stage * kStageBytes + dst;
    const long long tap = ((long long)ky * sh.W + kx) * sh.Cp + c;
    const bool k_ok = k < K;
#pragma unroll
    for (int i = 0; i < kARows; ++i) {
      const bool ok = k_ok && (unsigned)(iy0[i] + ky) < (unsigned)sh.H &&
                      (unsigned)(ix0[i] + kx) < (unsigned)sh.W;
      cp_async16(a + i * kPassBytes, ok ? xq + (a_org[i] + tap) : xq, ok);
    }
#pragma unroll
    for (int j = 0; j < kBRows; ++j) {
      const bool ok = k_ok && j < b_rows;
      cp_async16(a + kABytes + j * kPassBytes,
                 ok ? wrow + ((size_t)j * kRowsPass * K + k) : wq, ok);
    }
    k += kBK;
    c += kBK;
    settle();
  };

  const int wg = tid / 128;   // this warpgroup's rows: 64 wg .. 64 wg + 63
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 2; ++s) {
    if (s < KT) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 3>();   // this thread's copies of slab kt
    fence_proxy_async();
    __syncthreads();                // everyone's; slab kt - 2 read by all
    const uint32_t st = sbase + (kt % kStages) * kStageBytes;
    const uint64_t da = smem_desc(st + wg * (64 / 8) * kSBO);
    const uint64_t db = smem_desc(st + kABytes);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kBK / kKStep; ++s)   // the next 32 bytes of the rows
      Wgmma<BN>::mma(acc, da + s * (kKStep >> 4), db + s * (kKStep >> 4));
    wgmma_commit();
    const int next = kt + kStages - 2;
    if (next < KT) load(next % kStages);
    cp_async_commit();
    wgmma_wait<1>();
    fence_acc(acc);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  cp_async_wait<0>();
  __syncthreads();

  // epilogue. The fragment: warp w of the warpgroup holds rows 16 w +
  // lane / 4 (+ 8) and, in each 8-column group j, columns 8 j + 2 (lane %
  // 4) + {0, 1}: acc[4 j + 2 h + e] is row + 8 h, column + e.
  int* stage = reinterpret_cast<int*>(smem);
  const int warp = tid / 32, lane = tid % 32;
  const int frow = 64 * wg + 16 * (warp % 4) + lane / 4;
  const int fcol = 2 * (lane % 4);
  // the store phase: this lane's pixels m0 + lane + 32 i
  constexpr int kPix = kBM / 32;
  size_t obase[kPix];
  float sxp[kPix];
  bool p_ok[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const long long m = m0 + lane + 32 * i;
    p_ok[i] = m < M;
    const int b = p_ok[i] ? (int)(m / hw) : 0;
    const int p = p_ok[i] ? (int)(m - (long long)b * hw) : 0;
    obase[i] = (size_t)b * sh.N * hw + p;
    sxp[i] = p_ok[i] ? sx[b] : 0.f;
  }
#pragma unroll
  for (int cc = 0; cc < BN / kEpiChannels; ++cc) {
    if (n0 + cc * kEpiChannels >= sh.N) break;
#pragma unroll
    for (int j = 0; j < kEpiChannels / 8; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        stage[(8 * j + fcol + v % 2) * kEpiPitch + frow + 8 * (v / 2)] =
            acc[4 * (cc * kEpiChannels / 8 + j) + v];
    __syncthreads();
    for (int nl = warp; nl < kEpiChannels; nl += kConvThreads / 32) {
      const int n = n0 + cc * kEpiChannels + nl;
      if (n >= sh.N) break;
      const float swn = sw[n];
#pragma unroll
      for (int i = 0; i < kPix; ++i)
        if (p_ok[i])
          store(out + obase[i] + (size_t)n * hw,
                __fmul_rn(__int2float_rn(stage[nl * kEpiPitch + lane + 32 * i]),
                          __fmul_rn(sxp[i], swn)));
    }
    __syncthreads();
  }
}


// The shared memory of an instantiation is fixed (its ring), so the
// attribute that allows it is set once a device, not at every launch (a
// CUDA API call on the host's path of every served conv).
template <int BN, int kStages, typename TOut>
cudaError_t conv(const int8_t* xq, const float* sx, const int8_t* wq,
                 const float* sw, void* out, const ConvShape& sh, dim3 grid,
                 int smem, int device, cudaStream_t s) {
  const auto kernel = int8_conv_kernel<BN, kStages, TOut>;
  static bool allowed[64];
  if (device < 0 || device >= 64 || !allowed[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < 64) allowed[device] = true;
  }
  kernel<<<grid, kConvThreads, smem, s>>>(xq, sx, wq, sw,
                                          static_cast<TOut*>(out), sh);
  return cudaGetLastError();
}


// Makes `device` current for `launch` and restores the caller's device.
template <typename F>
int on_device(int device, F launch) {
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err == cudaSuccess) err = launch();
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

// One quantize launch (after the absmax launch in the dynamic mode) by
// instantiation. The shared memory allowed is set once a device, to the
// card's limit, not at every launch.
template <typename T, int kMode, bool kBN, bool kVec>
cudaError_t quantize_tile(const QuantArgs& a, int B, int smem, int device,
                          cudaStream_t s) {
  const auto kernel = quantize_kernel<T, kMode, kBN, kVec>;
  static bool allowed[64];
  if (device < 0 || device >= 64 || !allowed[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < 64) allowed[device] = true;
  }
  kernel<<<dim3((a.P + kQPix - 1) / kQPix, B), kQThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, bool kBN, bool kVec>
cudaError_t quantize_by_mode(QuantArgs a, int mode, unsigned* amax_scratch,
                             int B, int smem, int device, cudaStream_t s) {
  if (mode == kDynamic) {
    const int C = a.C1 + a.C2;
    const int blocks = C < kAmaxMaxBlocks ? C : kAmaxMaxBlocks;
    absmax_kernel<T, kBN, kVec><<<dim3(blocks, B), kAmaxThreads, 0, s>>>(
        a, amax_scratch);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    a.amax = reinterpret_cast<const float*>(amax_scratch);
    return quantize_tile<T, kDynamic, kBN, kVec>(a, B, smem, device, s);
  }
  if (mode == kStatic)
    return quantize_tile<T, kStatic, kBN, kVec>(a, B, smem, device, s);
  return quantize_tile<T, kPerChannel, kBN, kVec>(a, B, smem, device, s);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Checks the arguments and launches on `device` (made current, then
// restored). Returns a cudaError_t.
template <typename T, bool kBN>
int quantize_launch(QuantArgs a, int mode, unsigned* amax_scratch, int B,
                    int H, int W, int device, cudaStream_t s) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  const int C = a.C1 + a.C2;
  if (a.C1 <= 0 || a.C2 < 0 || a.Cp < C || a.Cp % kCinAlign != 0 ||
      mode < 0 || mode > 2 || B > 65535 || (long long)H * W > INT_MAX ||
      (a.C2 > 0) != (a.skip != nullptr) ||
      (mode == kDynamic && amax_scratch == nullptr) ||
      (mode != kDynamic && a.amax == nullptr) ||
      (mode == kPerChannel && a.t == nullptr) ||
      (kBN && (a.mean == nullptr || a.mul == nullptr || a.bias == nullptr)) ||
      !aligned16(a.xq))
    return (int)cudaErrorInvalidValue;
  a.P = H * W;
  const long long smem = quant_smem<T>(a.C1, a.C2, a.Cp, kBN,
                                       mode == kPerChannel);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  // 16-byte copies where no chunk straddles a channel row and every row
  // starts on 16 bytes
  const bool vec = a.P % (16 / (int)sizeof(T)) == 0 && aligned16(a.y) &&
                   (a.C2 == 0 || aligned16(a.skip));
  return on_device(device, [&] {
    return vec ? quantize_by_mode<T, kBN, true>(a, mode, amax_scratch, B,
                                                (int)smem, device, s)
               : quantize_by_mode<T, kBN, false>(a, mode, amax_scratch, B,
                                                 (int)smem, device, s);
  });
}

}  // namespace

extern "C" {

// x: [B,C,H,W] bfloat16 (x_bf16 = 1) or float32; mode 0 dynamic (amax_scratch
// [B] zeroed by the caller), 1 static (amax [1]), 2 per-channel (amax [1],
// t [C]); xq [B,H,W,Cp]; sx [B]. Returns a cudaError_t as an int.
int int8_quantize_launch(const void* x, int x_bf16, int mode,
                         const float* amax, const float* t,
                         unsigned* amax_scratch, int8_t* xq, float* sx, int B,
                         int C, int H, int W, int Cp, int device,
                         void* stream) {
  const QuantArgs a{x, nullptr, nullptr, nullptr, nullptr, amax, t,
                    xq, sx, C, 0, 0, Cp};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? quantize_launch<__nv_bfloat16, false>(a, mode, amax_scratch,
                                                        B, H, W, device, s)
                : quantize_launch<float, false>(a, mode, amax_scratch, B, H,
                                                W, device, s);
}

// relu(fma(y - mean, mul, bias)) of y [B,C1,H,W], then skip [B,C2,H,W] (or
// null with C2 = 0), both bfloat16 (x_bf16 = 1) or float32; mean, mul,
// bias [C1] float32; the modes as int8_quantize_launch's, t [C1 + C2];
// xq [B,H,W,Cp], sx [B]. Returns a cudaError_t as an int.
int int8_bn_relu_quantize_launch(const void* y, const void* skip,
                                 const float* mean, const float* mul,
                                 const float* bias, int x_bf16, int mode,
                                 const float* amax, const float* t,
                                 unsigned* amax_scratch, int8_t* xq,
                                 float* sx, int B, int C1, int C2, int H,
                                 int W, int Cp, int device, void* stream) {
  const QuantArgs a{y, skip, mean, mul, bias, amax, t, xq, sx, C1, C2, 0, Cp};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? quantize_launch<__nv_bfloat16, true>(a, mode, amax_scratch,
                                                       B, H, W, device, s)
                : quantize_launch<float, true>(a, mode, amax_scratch, B, H, W,
                                               device, s);
}

// xq [B,H,W,Cp] int8, sx [B], wq [N,kh,kw,Cp] int8, sw [N] -> out
// [B,N,Ho,Wo] bfloat16 (out_bf16 = 1) or float32, by the launch plan of
// ops/int8_conv.int8_conv_plan: tile width bn, stages, dynamic shared
// memory bytes and grid, refused unless it is one this file implements and
// fits the shape. Returns a cudaError_t as an int.
int int8_conv_launch(const int8_t* xq, const float* sx, const int8_t* wq,
                     const float* sw, void* out, int out_bf16, int B, int H,
                     int W, int Cp, int N, int kh, int kw, int stride, int pad,
                     int Ho, int Wo, int device, void* stream, int bn,
                     int stages, int smem, int grid_x, int grid_y) {
  if (B <= 0 || N <= 0 || Ho <= 0 || Wo <= 0) return 0;
  const long long M = (long long)B * Ho * Wo;
  const long long m_blocks = (M + kBM - 1) / kBM;
  if (Cp <= 0 || Cp % kCinAlign != 0 || kh <= 0 || kw <= 0 || stride <= 0 ||
      pad < 0 || (Ho - 1) * stride - pad + kh > H + pad ||
      (Wo - 1) * stride - pad + kw > W + pad || m_blocks > INT_MAX ||
      (long long)Ho * Wo > INT_MAX || (long long)kh * kw * Cp > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (bn <= 0 || grid_x != m_blocks || grid_y != (N + bn - 1) / bn ||
      grid_y > 65535 || smem != stages * (kBM + bn) * kBK)
    return (int)cudaErrorInvalidValue;
  const ConvShape sh{B, H, W, Cp, N, kh, kw, stride, pad, Ho, Wo};
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> cudaError_t {
#define INT8_CONV_PLAN(BN, STAGES)                                          \
  if (bn == BN && stages == STAGES)                                         \
    return out_bf16 ? conv<BN, STAGES, __nv_bfloat16>(                      \
                          xq, sx, wq, sw, out, sh, grid, smem, device, s)   \
                    : conv<BN, STAGES, float>(xq, sx, wq, sw, out, sh,      \
                                              grid, smem, device, s);
    INT8_CONV_PLANS(INT8_CONV_PLAN)
#undef INT8_CONV_PLAN
    return cudaErrorInvalidValue;
  });
}

const char* int8_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
