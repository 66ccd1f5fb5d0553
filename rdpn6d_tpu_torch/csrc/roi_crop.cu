// roi_crop: the network inputs of B ROIs cut from F RGB-D frames, in one
// pass. For each ROI (its frame by index, a square window of side `scale`
// centred at `center`) and each pixel of the S x S input crop:
//   * the bilinear crop of the frame's RGB (uint8 or float32 [F,H,W,3]),
//     normalised as (rgb - mean) / std unless `normalize` is 0;
//   * the bilinear crop of its depth (float32 metres [F,H,W], or int32
//     raw [F,H,W] divided by a float32 factor [F] at each tap), divided by
//     resize_ratio = O / scale and back-projected through the crop-composed
//     intrinsics Kc: ((j - cx') d / fx', (i - cy') d / fy', d);
// -> roi_img [B,S,S,6] = [rgb, xyz]; and at every stride-th row and column
// (stride = S / O) the O x O coordinate crop
// -> roi_coord_2d [B,O,O,5] = [xyz, the bilinear crop on the O grid of the
// frame's [0,1] coordinate map (linspace(0, 1, W)[x], linspace(0, 1, H)[y])].
// All float32, channels last.
//
// Replaces the TPU path's MXU rewrite of the eval half of the ROI
// preprocessing (no Pallas kernel): rdpn6d_tpu/ops/warp.py:130
// crop_resize_mm (the crop as Wy . img . Wx^T einsums of the matrices of
// _interp_matrix :98 at the source coordinates of _src_coords :38), as
// rdpn6d_tpu/data/pipeline.py:100 preprocess_roi runs it for the RGB
// (:138), its normalisation (:147-149), the depth (:153), the
// back-projection (_backproject_crop :86, :155), the concatenation (:158),
// the coordinate map's crop (:161 of coord_2d_map :77) and the strided
// concatenation (:163-165). In the port it replaces three gather chains
// (ops/warp.crop_resize_frames), the full-frame float depth, the
// coordinate map, the intrinsics' composition and a dozen elementwise ops:
// ~300 launches for a served batch of 16.
//
// Design for Hopper. What bounds it on the card is instruction issue and
// latency, not bytes: the gather's taps mostly hit L1 and L2, and each
// pixel needs ~100 float ops, six to ten divisions and the address and
// axis work around them. So the design spends few instructions a pixel and
// keeps loads in flight:
//  * A block of 256 threads walks `iters` tiles of one ROI (the ROI on
//    grid.y), one pixel a thread a tile: where S <= 256, R = 256 / S whole
//    rows a tile (blockDim (S, R)), so a thread keeps one column and its x
//    axis (taps, validities, fraction, O-grid column) is computed once;
//    else one 256-wide segment of a row a block. The grid is about one
//    wave of 3 blocks an SM (ops/roi_crop.roi_crop_plan), so the block's
//    set-up is paid a few hundred times, not once a tile.
//  * The set-up: the ROI's scalars (centre, the two grids' steps scale / S
//    and scale / O, resize_ratio, the four entries of Kc that the
//    back-projection reads, the frame, the depth factor, the reciprocals
//    of the divisors), each row's y axis (Row) and each tile's span of
//    O-grid pixels, computed once a block and staged in shared memory.
//  * A thread loads the next tile's taps (Taps) before it computes this
//    one's, so their latency hides behind the arithmetic.
//  * Each thread stores its pixel's 6 floats straight to roi_img (three
//    8-byte stores, 24 bytes apart across a warp, which L2 merges into
//    whole sectors), each O-grid pixel its xyz and the tile's first ng
//    threads the coordinate map of its ng grid pixels to roi_coord. Staging
//    the tile in shared memory for 16-byte stores cost more (a barrier a
//    tile) than the scattered stores did: slower at every shape measured.
//  * Every float op is an _rn intrinsic in ops/roi_crop.roi_crop_plain's
//    order, so that nvcc contracts nothing into an FMA, and the kernel
//    equals the plain version bit for bit: the source coordinate
//    centre + (j - S/2) * (scale / S) (ops/warp._src_coords, the step a
//    correctly rounded division); f = s - floor(s); each tap's value at the
//    clamped pixel times its 0/1 validity (a product, not a select, so a
//    NaN in the frame propagates as in the plain gather); the four taps
//    weighted ((v00 (1-fy)) (1-fx) + (v01 (1-fy)) fx) + (v10 fy) (1-fx) +
//    (v11 fy) fx, summed left to right; resize_ratio and Kc's scale from a
//    correctly rounded reciprocal of scale times O or S (PyTorch's
//    `O / scale`); Kc[i][j] = r K[i][j] + t_i K[2][j] with
//    t_i = S/2 - r c_i, the element-wise composition the plain version
//    writes in place of the matrix product; ((j - cx') d) / fx'. Each
//    division by a per-ROI constant (std, the factor, resize_ratio, fx',
//    fy') is the correctly rounded quotient from the divisor's reciprocal
//    and two FMAs (div_rn), with __fdiv_rn where that would under- or
//    overflow.
//  * The coordinate map is never built: its value at a tap is the axis'
//    linspace entry (passed in, computed by torch.linspace, which is not
//    i / (n - 1)) times the tap's validity.
//  * Offsets within a frame are 32-bit (3 H W < 2^31); a uint8 row's two
//    RGB taps come from the 1-3 aligned words that hold their 6 bytes, and
//    become floats by a byte permute and an add, not a conversion.
//  * Bound: bytes. The writes are B (S^2 6 + O^2 5) 4 bytes (26.5 MB at a
//    served batch of 16, 256 / 64); the reads at least each source pixel
//    of each ROI's window once, min(scale^2, H W) (3 + 4) bytes: ~8.5 us at
//    3.35 TB/s. TMA is not used: the taps are a gather at a fractional
//    stride.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

// A block of kThreads threads walks `iters` tiles of up to kThreads S-grid
// pixels of one ROI, one pixel a thread a tile: where S <= kThreads a tile
// is R = kThreads / S whole rows (blockDim (S, R)) and a thread keeps its
// column through the block's R iters rows (at most kMaxRows); else a
// block is one kThreads-wide segment of a row (blockDim (kThreads, 1),
// iters 1).
constexpr int kThreads = 256;
constexpr int kMaxRows = 256;

// The two taps of a bilinear axis at source coordinate s over n pixels:
// clamped indices, 0/1 validities and the fraction f.
struct Axis {
  int i0, i1;
  bool v0, v1;
  float f;
};

__device__ __forceinline__ Axis axis(float s, int n) {
  const float x0 = floorf(s);
  Axis a;
  a.f = __fsub_rn(s, x0);
  const long long k = (long long)x0;
  a.v0 = k >= 0 && k < n;
  a.v1 = k + 1 >= 0 && k + 1 < n;
  a.i0 = (int)min(max(k, 0LL), (long long)(n - 1));
  a.i1 = (int)min(max(k + 1, 0LL), (long long)(n - 1));
  return a;
}

__device__ __forceinline__ float valid(bool vy, bool vx) {
  return vy && vx ? 1.f : 0.f;
}

// ((v00 gy) gx + (v01 gy) fx) + (v10 fy) gx + (v11 fy) fx, gy = 1 - fy and
// gx = 1 - fx, each tap value already multiplied by its validity
__device__ __forceinline__ float blend(float v00, float v01, float v10,
                                       float v11, float fy, float fx, float gy,
                                       float gx) {
  const float a = __fmul_rn(__fmul_rn(v00, gy), gx);
  const float b = __fmul_rn(__fmul_rn(v01, gy), fx);
  const float c = __fmul_rn(__fmul_rn(v10, fy), gx);
  const float d = __fmul_rn(__fmul_rn(v11, fy), fx);
  return __fadd_rn(__fadd_rn(__fadd_rn(a, b), c), d);
}

__device__ __forceinline__ float blend(float v00, float v01, float v10,
                                       float v11, float fy, float fx) {
  return blend(v00, v01, v10, v11, fy, fx, __fsub_rn(1.f, fy),
               __fsub_rn(1.f, fx));
}

// One pixel's taps as loaded, before any arithmetic, so that a thread
// can load the next iteration's while it computes this one's. uint8 RGB:
// for each of the two source rows, the 1-3 aligned 32-bit words that hold
// the 6 bytes of its taps x0 and x1 (3 where x1 = x0; each word holds a
// byte of the frame, so no load leaves its allocation) and their shift;
// float32 RGB: the 6 values of each row's taps. Depth: the 4 taps, float32
// metres or int32 raw units.
struct TapsU8 {
  unsigned w[2][3];
  int sh[2];
};
struct TapsF32 {
  float v[2][6];
};
template <typename RgbT, bool kRaw>
struct Taps {
  typename std::conditional<std::is_same<RgbT, float>::value, TapsF32,
                            TapsU8>::type rgb;
  typename std::conditional<kRaw, int, float>::type d[4];
};

// The RGB taps of source row k at element offset a = (y W + x0) 3 of the
// frame p; x1 is x0 + 1, or x0 where the axis clamped it (two false).
__device__ __forceinline__ void load_rgb(TapsU8& t, int k,
                                         const unsigned char* p, int a,
                                         bool two) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p + a);
  const unsigned* w = reinterpret_cast<const unsigned*>(addr & ~uintptr_t{3});
  const int off = (int)(addr & 3), last = off + (two ? 5 : 2);
  t.sh[k] = 8 * off;
  t.w[k][0] = __ldg(w);
  t.w[k][1] = last >= 4 ? __ldg(w + 1) : 0u;
  t.w[k][2] = last >= 8 ? __ldg(w + 2) : 0u;
}

__device__ __forceinline__ void load_rgb(TapsF32& t, int k, const float* p,
                                         int a, bool two) {
  const int a1 = two ? a + 3 : a;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    t.v[k][c] = __ldg(p + a + c);
    t.v[k][3 + c] = __ldg(p + a1 + c);
  }
}

// Byte k of w as a float, exactly: the byte under the exponent of 2^23,
// less 2^23 (a byte permute and an add, where a conversion would take the
// slower conversion pipe).
__device__ __forceinline__ float byte_f(unsigned w, unsigned k) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, 0x4b000000u, 0x7650u | k)),
                   8388608.f);
}

// Row k's RGB as floats: taps x0 (v0) and x1 (v1)
__device__ __forceinline__ void rgb_values(const TapsU8& t, int k, bool two,
                                           float* v0, float* v1) {
  const unsigned lo = __funnelshift_r(t.w[k][0], t.w[k][1], t.sh[k]);
  const unsigned hi = __funnelshift_r(t.w[k][1], t.w[k][2], t.sh[k]);
  v0[0] = byte_f(lo, 0);
  v0[1] = byte_f(lo, 1);
  v0[2] = byte_f(lo, 2);
  v1[0] = two ? byte_f(lo, 3) : v0[0];
  v1[1] = two ? byte_f(hi, 0) : v0[1];
  v1[2] = two ? byte_f(hi, 1) : v0[2];
}

__device__ __forceinline__ void rgb_values(const TapsF32& t, int k, bool,
                                           float* v0, float* v1) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    v0[c] = t.v[k][c];
    v1[c] = t.v[k][3 + c];
  }
}

// RN(1 / d) for a divisor whose quotients may take div_rn's FMA path:
// |d| in [2^-125, 2^125], so the reciprocal is normal. NaN elsewhere,
// which sends every quotient by d to __fdiv_rn.
__device__ __forceinline__ float recip(float d) {
  const float m = fabsf(d);
  return m >= 0x1p-125f && m <= 0x1p125f ? __frcp_rn(d)
                                         : __int_as_float(0x7fc00000);
}

// a / d correctly rounded, as __fdiv_rn gives it, from r = recip(d): q0 =
// RN(a r) is within an ulp of a / d, the FMA gives the remainder a - q0 d
// exactly, and RN(q0 + rem r) is the correctly rounded quotient
// (Markstein's theorem), where nothing overflows or underflows. The FMA
// path is taken only where that is so: r normal (recip); 2^-125 <= |q0| <=
// 2^125, so q0 and the quotient are normal and q0 d stays finite; |a| >=
// 2^-100, so the remainder, a multiple of min(ulp(a), ulp(q0) ulp(d)) >=
// 2^-148, lies on the float grid and is exact. a = 0 gives q0 = +-0, the
// exact quotient. Anything else (a subnormal or huge quotient, a tiny
// numerator, NaN, an infinity, d out of range) takes __fdiv_rn.
__device__ __forceinline__ float div_rn(float a, float d, float r) {
  const float q0 = __fmul_rn(a, r);
  const float m = fabsf(q0);
  if (m >= 0x1p-125f && m <= 0x1p125f && fabsf(a) >= 0x1p-100f)
    return __fmaf_rn(__fmaf_rn(-q0, d, a), r, q0);
  if (a == 0.f && q0 == 0.f) return q0;
  return __fdiv_rn(a, d);
}

// A depth tap in metres: float32 as it is, int32 raw units divided by the
// frame's factor (r its reciprocal)
__device__ __forceinline__ float metres(float d, float, float) { return d; }
__device__ __forceinline__ float metres(int d, float factor, float r) {
  return div_rn((float)d, factor, r);
}

// Load the taps of the pixel in row r's axis (y0 W, y1 W) and the
// thread's column (x0, x1, two)
template <typename RgbT, bool kRaw>
__device__ __forceinline__ void load_taps(Taps<RgbT, kRaw>& t,
                                          const RgbT* rgbf,
                                          const void* dframe, int y0w,
                                          int y1w, int x0, int x1, bool two) {
  load_rgb(t.rgb, 0, rgbf, (y0w + x0) * 3, two);
  load_rgb(t.rgb, 1, rgbf, (y1w + x0) * 3, two);
  using D = typename std::conditional<kRaw, int, float>::type;
  const D* dp = static_cast<const D*>(dframe);
  t.d[0] = __ldg(dp + y0w + x0);
  t.d[1] = __ldg(dp + y0w + x1);
  t.d[2] = __ldg(dp + y1w + x0);
  t.d[3] = __ldg(dp + y1w + x1);
}

// The grid pixels (io, jo) of the O grid, at (io stride, jo stride) of the
// S grid, that come before flattened S-grid pixel P = i S + j: every grid
// row above row i, and in row i (where it is a grid row) the columns left
// of j. They are in the same order in roi_coord as in roi_img, so a block's
// contiguous run of S-grid pixels holds a contiguous run of grid pixels.
__device__ __forceinline__ int grid_before(int P, int S, int O, int stride) {
  const int i = P / S, j = P - i * S;
  int n = min(O, (i + stride - 1) / stride) * O;
  if (i % stride == 0 && i / stride < O) n += min(O, (j + stride - 1) / stride);
  return n;
}

// Staged per ROI: centre x, y; scale / S; scale / O; resize_ratio; Kc's
// fx, fy, cx, cy; the depth factor; the reciprocals (recip) of
// resize_ratio, fx', fy', the factor and the three stds
enum {
  kCx, kCy, kStepS, kStepO, kRatio, kFx, kFy, kKx, kKy, kFactor,
  kRRatio, kRFx, kRFy, kRFactor, kRStd, kN = kRStd + 3
};

// Staged per S-grid row of a block: the row axis' tap offsets y0 W and
// y1 W, its validities and fraction as floats, 1 - fy, the row index as
// a float, and its O-grid row (-1 off the grid); two 16-byte reads.
struct __align__(16) Row {
  int y0w, y1w;
  float wy0, wy1, fy, gy, fi;
  int io;
};

template <typename RgbT, bool kRaw>
__global__ void __launch_bounds__(kThreads, 3)
roi_crop_kernel(const RgbT* __restrict__ rgb, const void* __restrict__ depth,
                const float* __restrict__ depth_factor,
                const float* __restrict__ cam,
                const long long* __restrict__ frame_idx,
                const float* __restrict__ center,
                const float* __restrict__ scale,
                const float* __restrict__ lx, const float* __restrict__ ly,
                float* __restrict__ roi_img, float* __restrict__ roi_coord,
                int F, int H, int W, int S, int O, int stride, int iters,
                float mean0, float mean1, float mean2, float std0,
                float std1, float std2, int normalize) {
  __shared__ Row srow[kMaxRows];
  __shared__ int2 sgrid[kMaxRows];          // an iteration's g0 and ng
  __shared__ float sc[kN];
  __shared__ long long sfr;
  const int b = blockIdx.y;
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;
  // the block: rows [row0, row0 + rows) whole, blockDim.y of them an
  // iteration; or the segment [col0, col0 + blockDim.x) of row row0
  const int nseg = (S + kThreads - 1) / kThreads;
  const int R = blockDim.y;
  const int row0 = nseg == 1 ? blockIdx.x * R * iters : blockIdx.x / nseg;
  const int col0 = nseg == 1 ? 0 : (blockIdx.x - row0 * nseg) * kThreads;
  const int rows = min(R * iters, S - row0);
  const int ncol = nseg == 1 ? S : min(kThreads, S - col0);
  if (t == 0) sfr = frame_idx[b];
  if (t < 2) sc[kCx + t] = center[(size_t)b * 2 + t];
  if (t == 2) sc[kStepS] = __fdiv_rn(scale[b], (float)S);
  if (t == 3) sc[kStepO] = __fdiv_rn(scale[b], (float)O);
  if (t == 4) {
    const float ratio = __fmul_rn(__frcp_rn(scale[b]), (float)O);
    sc[kRatio] = ratio;
    sc[kRRatio] = recip(ratio);
  }
  if (t >= 11 && t < 14) {
    const float sd = t == 11 ? std0 : t == 12 ? std1 : std2;
    sc[kRStd + t - 11] = recip(sd);
  }
  for (int k = t; k < iters; k += nt) {
    // iteration k's span of S-grid pixels and the grid pixels inside it
    const int pa = nseg == 1 ? min(row0 + R * k, S) * S : row0 * S + col0;
    const int pb = nseg == 1 ? min(row0 + R * k + R, S) * S : pa + ncol;
    const int g0 = grid_before(pa, S, O, stride);
    sgrid[k] = make_int2(g0, grid_before(pb, S, O, stride) - g0);
  }
  __syncthreads();
  const long long f = sfr;
  if (f < 0 || f >= F) __trap();           // as an index assert would
  if (t >= 5 && t < 9) {
    // Kc[i][j] = r K[i][j] + t_i K[2][j], r = S / scale,
    // t_i = S/2 - r c_i: fx' (0,0), fy' (1,1), cx' (0,2), cy' (1,2)
    const int row = (t - 5) & 1, col = t < 7 ? row : 2;
    const float* k = cam + f * 9;
    const float r = __fmul_rn(__frcp_rn(scale[b]), (float)S);
    const float ti = __fsub_rn(0.5f * (float)S, __fmul_rn(r, sc[kCx + row]));
    const float kc = __fadd_rn(__fmul_rn(r, k[row * 3 + col]),
                               __fmul_rn(ti, k[6 + col]));
    sc[kFx + (t - 5)] = kc;
    if (t < 7) sc[kRFx + (t - 5)] = recip(kc);
  }
  if (t == 9) {
    const float fac = kRaw ? depth_factor[f] : 1.f;
    sc[kFactor] = fac;
    sc[kRFactor] = recip(fac);
  }
  const float half = 0.5f * (float)S;
  for (int k = t; k < rows; k += nt) {
    // the S-grid row's taps, as ops/warp._src_coords takes them
    const int i = row0 + k;
    const Axis ay = axis(__fadd_rn(sc[kCy], __fmul_rn(__fsub_rn((float)i,
                                                                half),
                                                      sc[kStepS])), H);
    Row r;
    r.y0w = ay.i0 * W;
    r.y1w = ay.i1 * W;
    r.wy0 = ay.v0 ? 1.f : 0.f;
    r.wy1 = ay.v1 ? 1.f : 0.f;
    r.fy = ay.f;
    r.gy = __fsub_rn(1.f, ay.f);
    r.fi = (float)i;
    r.io = i % stride == 0 ? i / stride : -1;
    srow[k] = r;
  }
  __syncthreads();

  // the thread's column, the same through every iteration; offsets within
  // the frame in 32 bits (the launcher admits H W 3 < 2^31)
  const int j = col0 + threadIdx.x;
  const Axis ax = axis(__fadd_rn(sc[kCx], __fmul_rn(__fsub_rn((float)j, half),
                                                    sc[kStepS])), W);
  const float wx0 = ax.v0 ? 1.f : 0.f, wx1 = ax.v1 ? 1.f : 0.f;
  const float gx = __fsub_rn(1.f, ax.f);
  const bool two = ax.i1 != ax.i0;
  const int jo = j % stride == 0 ? j / stride : -1;
  const float jk = __fsub_rn((float)j, sc[kKx]);
  const size_t frame = (size_t)f * H * W;
  const RgbT* rgbf = rgb + frame * 3;
  const void* dframe =
      kRaw ? static_cast<const void*>(static_cast<const int*>(depth) + frame)
           : static_cast<const void*>(static_cast<const float*>(depth) +
                                      frame);
  const float mean[3] = {mean0, mean1, mean2};
  const float sd[3] = {std0, std1, std2};
  const float fac = sc[kFactor], rfac = sc[kRFactor];
  const float ratio = sc[kRatio], rratio = sc[kRRatio];
  const float kfx = sc[kFx], rkfx = sc[kRFx];
  const float kfy = sc[kFy], rkfy = sc[kRFy], kky = sc[kKy];
  const float rsd[3] = {sc[kRStd], sc[kRStd + 1], sc[kRStd + 2]};

  const bool col_live = (int)threadIdx.x < ncol;
  Taps<RgbT, kRaw> next;                 // the taps of the next iteration
  if ((int)threadIdx.y < rows && col_live) {
    const int2 yw = *reinterpret_cast<const int2*>(&srow[threadIdx.y]);
    load_taps(next, rgbf, dframe, yw.x, yw.y, ax.i0, ax.i1, two);
  }
  for (int it = 0; R * it < rows; ++it) {
    const int lr = R * it + threadIdx.y;             // the block's row
    const Taps<RgbT, kRaw> cur = next;
    if (lr + R < rows && col_live) {
      const int2 yw = *reinterpret_cast<const int2*>(&srow[lr + R]);
      load_taps(next, rgbf, dframe, yw.x, yw.y, ax.i0, ax.i1, two);
    }
    const int2 gs = sgrid[it];
    const int g0 = gs.x, ng = gs.y;
    const int pa = (row0 + R * it) * S + col0;
    float* img_dst = roi_img + ((size_t)b * S * S + pa) * 6;
    float* coord_dst = roi_coord + ((size_t)b * O * O + g0) * 5;
    if (lr < rows && col_live) {
      const Row r = srow[lr];
      const float w00 = __fmul_rn(r.wy0, wx0), w01 = __fmul_rn(r.wy0, wx1);
      const float w10 = __fmul_rn(r.wy1, wx0), w11 = __fmul_rn(r.wy1, wx1);

      float px[6], v00[3], v01[3], v10[3], v11[3];
      rgb_values(cur.rgb, 0, two, v00, v01);
      rgb_values(cur.rgb, 1, two, v10, v11);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float v = blend(__fmul_rn(v00[c], w00), __fmul_rn(v01[c], w01),
                              __fmul_rn(v10[c], w10), __fmul_rn(v11[c], w11),
                              r.fy, ax.f, r.gy, gx);
        px[c] = normalize ? div_rn(__fsub_rn(v, mean[c]), sd[c], rsd[c]) : v;
      }
      const float d =
          blend(__fmul_rn(metres(cur.d[0], fac, rfac), w00),
                __fmul_rn(metres(cur.d[1], fac, rfac), w01),
                __fmul_rn(metres(cur.d[2], fac, rfac), w10),
                __fmul_rn(metres(cur.d[3], fac, rfac), w11), r.fy, ax.f, r.gy,
                gx);
      const float z = div_rn(d, ratio, rratio);
      px[3] = div_rn(__fmul_rn(jk, z), kfx, rkfx);
      px[4] = div_rn(__fmul_rn(__fsub_rn(r.fi, kky), z), kfy, rkfy);
      px[5] = z;
      // straight to roi_img, three 8-byte stores 24 bytes apart across the
      // warp, which L2 merges into whole sectors
      float2* o = reinterpret_cast<float2*>(img_dst + 6 * t);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        o[k] = make_float2(px[2 * k], px[2 * k + 1]);
      if (r.io >= 0 && jo >= 0) {
        // the strided xyz of the O grid: this pixel's own
        float* row = coord_dst + 5 * (r.io * O + jo - g0);
        row[0] = px[3];
        row[1] = px[4];
        row[2] = px[5];
      }
    }
    if (t < ng) {
      // the coordinate map's crop at grid pixel g0 + t, on the O grid's
      // taps
      const int g = g0 + t;
      const int io = g / O, jg = g - io * O;
      const float half_o = 0.5f * (float)O;
      const Axis bx = axis(__fadd_rn(sc[kCx], __fmul_rn(__fsub_rn((float)jg,
                                                                  half_o),
                                                        sc[kStepO])), W);
      const Axis by = axis(__fadd_rn(sc[kCy], __fmul_rn(__fsub_rn((float)io,
                                                                  half_o),
                                                        sc[kStepO])), H);
      const float u00 = valid(by.v0, bx.v0), u01 = valid(by.v0, bx.v1);
      const float u10 = valid(by.v1, bx.v0), u11 = valid(by.v1, bx.v1);
      const float x0 = __ldg(lx + bx.i0), x1 = __ldg(lx + bx.i1);
      const float y0 = __ldg(ly + by.i0), y1 = __ldg(ly + by.i1);
      float* row = coord_dst + 5 * t;
      row[3] = blend(__fmul_rn(x0, u00), __fmul_rn(x1, u01),
                     __fmul_rn(x0, u10), __fmul_rn(x1, u11), by.f, bx.f);
      row[4] = blend(__fmul_rn(y0, u00), __fmul_rn(y0, u01),
                     __fmul_rn(y1, u10), __fmul_rn(y1, u11), by.f, bx.f);
    }
  }
}

template <typename RgbT, bool kRaw>
void launch(dim3 grid, dim3 block, cudaStream_t s, const void* rgb, const void* depth,
            const float* depth_factor, const float* cam,
            const long long* frame_idx, const float* center,
            const float* scale, const float* lx, const float* ly,
            float* roi_img, float* roi_coord, int F, int H, int W, int S,
            int O, int stride, int iters, const float* mean,
            const float* std, int normalize) {
  roi_crop_kernel<RgbT, kRaw><<<grid, block, 0, s>>>(
      static_cast<const RgbT*>(rgb), depth, depth_factor, cam, frame_idx,
      center, scale, lx, ly, roi_img, roi_coord, F, H, W, S, O, stride,
      iters, mean[0], mean[1], mean[2], std[0], std[1], std[2], normalize);
}

}  // namespace

extern "C" {

// rgb_u8 != 0: rgb is uint8, else float32. depth_factor non-null: depth is
// int32 raw units, else float32 metres. frame_idx int64 [B], each in
// [0, F); O <= S with ceil(S / stride) == O for stride = S / O. iters:
// the tiles a block walks (ops/roi_crop.roi_crop_plan): 1 where S >
// kThreads, else at most kMaxRows / R. mean, std: 3 floats each on the
// host. Returns cudaGetLastError().
int roi_crop_launch(const void* rgb, int rgb_u8, const void* depth,
                    const float* depth_factor, const float* cam,
                    const long long* frame_idx, const float* center,
                    const float* scale, const float* lx, const float* ly,
                    float* roi_img, float* roi_coord, int B, int F, int H,
                    int W, int S, int O, int iters, const float* mean,
                    const float* std, int normalize, void* stream) {
  if (B <= 0) return 0;
  if (F <= 0 || H <= 0 || W <= 0 || S <= 0 || O <= 0 || O > S)
    return (int)cudaErrorInvalidValue;
  const int stride = S / O;
  if ((S + stride - 1) / stride != O) return (int)cudaErrorInvalidValue;
  if ((long long)H * W * 3 > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // whole rows of S <= kThreads pixels, R of them an iteration and R iters
  // a block; else a kThreads-wide segment of a row a block
  const int nseg = (S + kThreads - 1) / kThreads;
  const int R = nseg == 1 ? kThreads / S : 1;
  if (iters < 1 || R * iters > kMaxRows || (nseg > 1 && iters != 1))
    return (int)cudaErrorInvalidValue;
  const dim3 block(nseg == 1 ? S : kThreads, R);
  const dim3 grid(nseg == 1 ? (S + R * iters - 1) / (R * iters) : S * nseg,
                  B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool raw = depth_factor != nullptr;
  if (rgb_u8 && raw)
    launch<unsigned char, true>(grid, block, s, rgb, depth, depth_factor, cam,
                                frame_idx, center, scale, lx, ly, roi_img,
                                roi_coord, F, H, W, S, O, stride, iters, mean,
                                std, normalize);
  else if (rgb_u8)
    launch<unsigned char, false>(grid, block, s, rgb, depth, depth_factor,
                                 cam, frame_idx, center, scale, lx, ly,
                                 roi_img, roi_coord, F, H, W, S, O, stride,
                                 iters, mean, std, normalize);
  else if (raw)
    launch<float, true>(grid, block, s, rgb, depth, depth_factor, cam,
                        frame_idx, center, scale, lx, ly, roi_img, roi_coord,
                        F, H, W, S, O, stride, iters, mean, std, normalize);
  else
    launch<float, false>(grid, block, s, rgb, depth, depth_factor, cam,
                         frame_idx, center, scale, lx, ly, roi_img, roi_coord,
                         F, H, W, S, O, stride, iters, mean, std, normalize);
  return (int)cudaGetLastError();
}

const char* roi_crop_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
