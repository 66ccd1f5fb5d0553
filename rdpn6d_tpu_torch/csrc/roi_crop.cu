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
// Design for Hopper:
//  * One thread an S x S output pixel, 128 a block, the ROI on grid.y. The
//    ROI's scalars (centre, the two grids' steps scale / S and scale / O,
//    resize_ratio, the four entries of Kc that the back-projection reads,
//    the frame, the depth factor) are computed by a few threads and staged
//    once per block in shared memory.
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
//    writes in place of the matrix product; ((j - cx') d) / fx'.
//  * The coordinate map is never built: its value at a tap is the axis'
//    linspace entry (passed in, computed by torch.linspace, which is not
//    i / (n - 1)) times the tap's validity.
//  * Bound: bytes. The writes are B (S^2 6 + O^2 5) 4 bytes (26.5 MB at a
//    served batch of 16, 256 / 64); the reads at least each source pixel
//    of each ROI's window once, min(scale^2, H W) (3 + 4) bytes: ~9 us at
//    3.35 TB/s. A thread stores its 6 floats as three 8-byte stores, 24
//    bytes apart across the warp; the 5-float coordinate rows are scalar
//    stores. Staging the tile in shared memory for coalesced stores is
//    left for later: the gain this design goes for is the ~300 launches.
//    TMA is not used: the taps are a gather at a fractional stride.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

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

// ((v00 (1-fy)) (1-fx) + (v01 (1-fy)) fx) + (v10 fy) (1-fx) + (v11 fy) fx,
// each tap value already multiplied by its validity
__device__ __forceinline__ float blend(float v00, float v01, float v10,
                                       float v11, float fy, float fx) {
  const float gy = __fsub_rn(1.f, fy), gx = __fsub_rn(1.f, fx);
  const float a = __fmul_rn(__fmul_rn(v00, gy), gx);
  const float b = __fmul_rn(__fmul_rn(v01, gy), fx);
  const float c = __fmul_rn(__fmul_rn(v10, fy), gx);
  const float d = __fmul_rn(__fmul_rn(v11, fy), fx);
  return __fadd_rn(__fadd_rn(__fadd_rn(a, b), c), d);
}

__device__ __forceinline__ float rgb_at(const unsigned char* p, size_t i) {
  return (float)__ldg(p + i);
}

__device__ __forceinline__ float rgb_at(const float* p, size_t i) {
  return __ldg(p + i);
}

// kRaw: depth is int32 raw units, divided by the frame's factor per tap
template <bool kRaw>
__device__ __forceinline__ float depth_at(const void* depth, size_t i,
                                          float factor) {
  if (kRaw)
    return __fdiv_rn((float)__ldg(static_cast<const int*>(depth) + i),
                     factor);
  return __ldg(static_cast<const float*>(depth) + i);
}

// Staged per ROI: centre x, y; scale / S; scale / O; resize_ratio; Kc's
// fx, fy, cx, cy; the depth factor
enum { kCx, kCy, kStepS, kStepO, kRatio, kFx, kFy, kKx, kKy, kFactor, kN };

template <typename RgbT, bool kRaw>
__global__ void __launch_bounds__(kThreads)
roi_crop_kernel(const RgbT* __restrict__ rgb, const void* __restrict__ depth,
                const float* __restrict__ depth_factor,
                const float* __restrict__ cam,
                const long long* __restrict__ frame_idx,
                const float* __restrict__ center,
                const float* __restrict__ scale,
                const float* __restrict__ lx, const float* __restrict__ ly,
                float* __restrict__ roi_img, float* __restrict__ roi_coord,
                int F, int H, int W, int S, int O, int stride, float mean0,
                float mean1, float mean2, float std0, float std1, float std2,
                int normalize) {
  __shared__ float sc[kN];
  __shared__ long long sfr;
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  if (t == 0) sfr = frame_idx[b];
  if (t < 2) sc[kCx + t] = center[(size_t)b * 2 + t];
  if (t == 2) sc[kStepS] = __fdiv_rn(scale[b], (float)S);
  if (t == 3) sc[kStepO] = __fdiv_rn(scale[b], (float)O);
  if (t == 4) sc[kRatio] = __fmul_rn(__frcp_rn(scale[b]), (float)O);
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
    sc[kFx + (t - 5)] = __fadd_rn(__fmul_rn(r, k[row * 3 + col]),
                                  __fmul_rn(ti, k[6 + col]));
  }
  if (t == 9) sc[kFactor] = kRaw ? depth_factor[f] : 1.f;
  __syncthreads();
  const int p = blockIdx.x * kThreads + t;
  if (p >= S * S) return;

  // the S-grid taps, as ops/warp._src_coords takes them
  const int i = p / S, j = p - i * S;
  const float half = 0.5f * (float)S;
  const Axis ax = axis(__fadd_rn(sc[kCx], __fmul_rn(__fsub_rn((float)j, half),
                                                    sc[kStepS])), W);
  const Axis ay = axis(__fadd_rn(sc[kCy], __fmul_rn(__fsub_rn((float)i, half),
                                                    sc[kStepS])), H);
  const float w00 = valid(ay.v0, ax.v0), w01 = valid(ay.v0, ax.v1);
  const float w10 = valid(ay.v1, ax.v0), w11 = valid(ay.v1, ax.v1);
  const size_t frame = (size_t)f * H * W;
  const size_t p00 = frame + (size_t)ay.i0 * W + ax.i0;
  const size_t p01 = frame + (size_t)ay.i0 * W + ax.i1;
  const size_t p10 = frame + (size_t)ay.i1 * W + ax.i0;
  const size_t p11 = frame + (size_t)ay.i1 * W + ax.i1;

  float px[6];
  const float mean[3] = {mean0, mean1, mean2};
  const float sd[3] = {std0, std1, std2};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v = blend(__fmul_rn(rgb_at(rgb, p00 * 3 + c), w00),
                          __fmul_rn(rgb_at(rgb, p01 * 3 + c), w01),
                          __fmul_rn(rgb_at(rgb, p10 * 3 + c), w10),
                          __fmul_rn(rgb_at(rgb, p11 * 3 + c), w11), ay.f,
                          ax.f);
    px[c] = normalize ? __fdiv_rn(__fsub_rn(v, mean[c]), sd[c]) : v;
  }
  const float fac = sc[kFactor];
  const float d = blend(__fmul_rn(depth_at<kRaw>(depth, p00, fac), w00),
                        __fmul_rn(depth_at<kRaw>(depth, p01, fac), w01),
                        __fmul_rn(depth_at<kRaw>(depth, p10, fac), w10),
                        __fmul_rn(depth_at<kRaw>(depth, p11, fac), w11), ay.f,
                        ax.f);
  const float z = __fdiv_rn(d, sc[kRatio]);
  px[3] = __fdiv_rn(__fmul_rn(__fsub_rn((float)j, sc[kKx]), z), sc[kFx]);
  px[4] = __fdiv_rn(__fmul_rn(__fsub_rn((float)i, sc[kKy]), z), sc[kFy]);
  px[5] = z;
  float2* out = reinterpret_cast<float2*>(roi_img + ((size_t)b * S * S + p) * 6);
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = make_float2(px[2 * k], px[2 * k + 1]);

  if (i % stride != 0 || j % stride != 0) return;
  // the O-grid row: the strided xyz and the coordinate map's crop
  const int io = i / stride, jo = j / stride;
  const float half_o = 0.5f * (float)O;
  const Axis bx = axis(__fadd_rn(sc[kCx], __fmul_rn(__fsub_rn((float)jo,
                                                              half_o),
                                                    sc[kStepO])), W);
  const Axis by = axis(__fadd_rn(sc[kCy], __fmul_rn(__fsub_rn((float)io,
                                                              half_o),
                                                    sc[kStepO])), H);
  const float u00 = valid(by.v0, bx.v0), u01 = valid(by.v0, bx.v1);
  const float u10 = valid(by.v1, bx.v0), u11 = valid(by.v1, bx.v1);
  const float x0 = __ldg(lx + bx.i0), x1 = __ldg(lx + bx.i1);
  const float y0 = __ldg(ly + by.i0), y1 = __ldg(ly + by.i1);
  float* row = roi_coord + ((size_t)b * O * O + (size_t)io * O + jo) * 5;
  row[0] = px[3];
  row[1] = px[4];
  row[2] = px[5];
  row[3] = blend(__fmul_rn(x0, u00), __fmul_rn(x1, u01), __fmul_rn(x0, u10),
                 __fmul_rn(x1, u11), by.f, bx.f);
  row[4] = blend(__fmul_rn(y0, u00), __fmul_rn(y0, u01), __fmul_rn(y1, u10),
                 __fmul_rn(y1, u11), by.f, bx.f);
}

template <typename RgbT, bool kRaw>
void launch(dim3 grid, cudaStream_t s, const void* rgb, const void* depth,
            const float* depth_factor, const float* cam,
            const long long* frame_idx, const float* center,
            const float* scale, const float* lx, const float* ly,
            float* roi_img, float* roi_coord, int F, int H, int W, int S,
            int O, int stride, const float* mean, const float* std,
            int normalize) {
  roi_crop_kernel<RgbT, kRaw><<<grid, kThreads, 0, s>>>(
      static_cast<const RgbT*>(rgb), depth, depth_factor, cam, frame_idx,
      center, scale, lx, ly, roi_img, roi_coord, F, H, W, S, O, stride,
      mean[0], mean[1], mean[2], std[0], std[1], std[2], normalize);
}

}  // namespace

extern "C" {

// rgb_u8 != 0: rgb is uint8, else float32. depth_factor non-null: depth is
// int32 raw units, else float32 metres. frame_idx int64 [B], each in
// [0, F); O <= S with ceil(S / stride) == O for stride = S / O. mean, std:
// 3 floats each on the host. Returns cudaGetLastError().
int roi_crop_launch(const void* rgb, int rgb_u8, const void* depth,
                    const float* depth_factor, const float* cam,
                    const long long* frame_idx, const float* center,
                    const float* scale, const float* lx, const float* ly,
                    float* roi_img, float* roi_coord, int B, int F, int H,
                    int W, int S, int O, const float* mean, const float* std,
                    int normalize, void* stream) {
  if (B <= 0) return 0;
  if (F <= 0 || H <= 0 || W <= 0 || S <= 0 || O <= 0 || O > S)
    return (int)cudaErrorInvalidValue;
  const int stride = S / O;
  if ((S + stride - 1) / stride != O) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)(((long long)S * S + kThreads - 1) / kThreads), B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool raw = depth_factor != nullptr;
  if (rgb_u8 && raw)
    launch<unsigned char, true>(grid, s, rgb, depth, depth_factor, cam,
                                frame_idx, center, scale, lx, ly, roi_img,
                                roi_coord, F, H, W, S, O, stride, mean, std,
                                normalize);
  else if (rgb_u8)
    launch<unsigned char, false>(grid, s, rgb, depth, depth_factor, cam,
                                 frame_idx, center, scale, lx, ly, roi_img,
                                 roi_coord, F, H, W, S, O, stride, mean, std,
                                 normalize);
  else if (raw)
    launch<float, true>(grid, s, rgb, depth, depth_factor, cam, frame_idx,
                        center, scale, lx, ly, roi_img, roi_coord, F, H, W, S,
                        O, stride, mean, std, normalize);
  else
    launch<float, false>(grid, s, rgb, depth, depth_factor, cam, frame_idx,
                         center, scale, lx, ly, roi_img, roi_coord, F, H, W,
                         S, O, stride, mean, std, normalize);
  return (int)cudaGetLastError();
}

const char* roi_crop_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
