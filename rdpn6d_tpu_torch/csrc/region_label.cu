// RDPN's train labels, two entry points.
//
// region_label: for each pixel of a cropped object-frame xyz map, the
// nearest FPS keypoint (region 1..K, 0 at the background, where xyz = 0)
// and the normalized camera-rotated residual
//     coord = R (xyz - fps[nearest]) / extent + 0.5,
// batched over ROIs. xyz [B,N,3] (N = H*W), fps [B,K,3], R [B,3,3],
// extent [B,3], all float32 -> region [B,N] int32, coord [B,N,3] float32.
// The train pipeline's depth-surface branch (no GT xyz map shipped) and
// ops/region.xyz_to_region call it.
//
// gt_labels: the whole xyz-shipped branch of the train labels in one pass.
// For each of B ROIs and each pixel of its out x out label crop, the
// nearest-neighbour tap of the ROI's full-size GT maps (packed uint8 masks,
// bit 0 visib and bit 1 trunc, or float32 visib with an optional trunc;
// xyz in float16 or float32, read in its own type), then the masks, the
// region id and the coordinate target: the residual above, or
// xyz / extent + 0.5 (GDR-Net's absolute mode). -> visib, obj, trunc
// [B,o,o] float32 (trunc only with a trunc plane), region [B,o,o] int32,
// coord [B,o,o,3] float32.
//
// Replaces the TPU path's MXU rewrites (no Pallas kernel):
// rdpn6d_tpu/ops/region.py:21-74 (xyz_to_region + residual_coord_target:
// distances as |x|^2 - 2 x.f + |f|^2 with the cross term an einsum at
// precision="highest", an argmin, a gather and a second einsum) and, for
// gt_labels, also rdpn6d_tpu/data/pipeline.py:197-221, the nearest crop
// of the stacked mask and xyz planes as 0/1 selection-matrix matmuls
// (rdpn6d_tpu/ops/warp.py:115 _select_matrix, :130 crop_resize_mm).
//
// Design for Hopper:
//  * One thread an output pixel; the ROI's keypoints (as float4), R,
//    extent (and, for gt_labels, centre and r = scale / out) are staged
//    once per block in shared memory, and every thread of a warp reads the
//    same keypoint at once (a broadcast, no bank conflict). The last block
//    of a ROI masks its tail.
//  * The distance is the direct form sum_d (x_d - f_d)^2 in true float32,
//    with __fsub_rn/__fmul_rn/__fadd_rn so that nvcc contracts nothing into
//    FMAs: the sum rounds exactly as the plain PyTorch version's
//    ((dx^2 + dy^2) + dz^2), and the two pick the same keypoint. The
//    expanded (GEMM) form would cancel for points ~0.1 m from the origin,
//    so the tensor cores are not used.
//  * Ties go to the lowest index, as jnp.argmin and torch.argmin do: a
//    strict < in ascending k.
//  * Background pixels still get a coordinate: their nearest keypoint is
//    the one nearest the origin, and the JAX package emits that too.
//  * gt_labels reads the source maps only at the out^2 taps, in the types
//    they are shipped in (__ldg of a byte and of three halves), so neither
//    the float32 widening of the full-size maps nor their stacked copy is
//    ever written. The source coordinate follows ops/warp.py op for op in
//    float32 (r = scale / out, then (j - out/2) * r, then centre + ...)
//    with __fdiv_rn/__fmul_rn/__fadd_rn, and rounds half to even (rintf),
//    so every tap, hence every mask, is the plain version's bit for bit:
//    a contracted FMA would move an exact .5 and flip a pixel. An
//    out-of-map tap reads the clamped pixel times 0, as the plain gather
//    does. TMA is not used: the taps are a gather at a fractional stride,
//    which no TMA tile describes.
//  * Bound: bytes. region_label moves 28 B a pixel (12 in, 16 out);
//    gt_labels 35 B with packed masks and float16 xyz (1 + 6 in, 3 x 4 of
//    masks + 4 of region + 12 of coord out), 3.44 MB at the train shape
//    (24 ROIs of 64x64, K = 32), ~1.03 us at 3.35 TB/s, against ~22e6
//    FP32 instructions, ~0.66 us at 33.5e12/s. A launch this small is
//    dominated by its fixed cost; taking the crop's dozen launches into it
//    is the gain this design goes for.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLabelThreads = 128;
constexpr int kMaxK = 64;

// Stages the ROI's keypoints, R and extent in shared memory (callers
// __syncthreads() before reading them).
__device__ __forceinline__ void stage_roi(const float* __restrict__ fps,
                                          const float* __restrict__ rot,
                                          const float* __restrict__ extent,
                                          int b, int K, float4* sf, float* sr,
                                          float* se) {
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float* f = fps + ((size_t)b * K + k) * 3;
    sf[k] = make_float4(f[0], f[1], f[2], 0.f);
  }
  if (threadIdx.x < 9) sr[threadIdx.x] = rot[(size_t)b * 9 + threadIdx.x];
  if (threadIdx.x < 3) se[threadIdx.x] = extent[(size_t)b * 3 + threadIdx.x];
}

// Index of the nearest keypoint: the direct form without FMA contraction,
// first minimum on ties.
__device__ __forceinline__ int nearest_keypoint(const float4* sf, int K,
                                                float x, float y, float z) {
  float best = CUDART_INF_F;
  int arg = 0;
  for (int k = 0; k < K; ++k) {
    const float4 f = sf[k];
    const float dx = __fsub_rn(x, f.x);
    const float dy = __fsub_rn(y, f.y);
    const float dz = __fsub_rn(z, f.z);
    const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                              __fmul_rn(dz, dz));
    if (d < best) {
      best = d;
      arg = k;
    }
  }
  return arg;
}

// region (0 at the background) and coord = R (xyz - f) / extent + 0.5.
__device__ __forceinline__ void label_pixel(const float4* sf, const float* sr,
                                            const float* se, int K, float x,
                                            float y, float z, int* region,
                                            float* coord) {
  const int arg = nearest_keypoint(sf, K, x, y, z);
  const bool fg = (x != 0.f) || (y != 0.f) || (z != 0.f);
  *region = fg ? arg + 1 : 0;
  const float4 f = sf[arg];
  const float dx = x - f.x, dy = y - f.y, dz = z - f.z;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float r = sr[3 * i] * dx + sr[3 * i + 1] * dy + sr[3 * i + 2] * dz;
    coord[i] = r / se[i] + 0.5f;
  }
}

__global__ void __launch_bounds__(kThreads)
region_label_kernel(const float* __restrict__ xyz,
                    const float* __restrict__ fps,
                    const float* __restrict__ rot,
                    const float* __restrict__ extent,
                    int* __restrict__ region, float* __restrict__ coord,
                    int N, int K) {
  __shared__ float4 sf[kMaxK];
  __shared__ float sr[9];
  __shared__ float se[3];
  const int b = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  stage_roi(fps, rot, extent, b, K, sf, sr, se);
  __syncthreads();
  if (p >= N) return;

  const size_t pix = (size_t)b * N + p;
  label_pixel(sf, sr, se, K, xyz[pix * 3 + 0], xyz[pix * 3 + 1],
              xyz[pix * 3 + 2], region + pix, coord + pix * 3);
}

__device__ __forceinline__ float load_xyz(const float* __restrict__ p,
                                          size_t i) {
  return __ldg(p + i);
}

__device__ __forceinline__ float load_xyz(const __half* __restrict__ p,
                                          size_t i) {
  const unsigned short bits =
      __ldg(reinterpret_cast<const unsigned short*>(p) + i);
  return __half2float(__ushort_as_half(bits));   // exact
}

// kPacked: mask is uint8 [B,h,w], visib = bit 0, trunc = bit 1.
// Otherwise mask is float32 visib [B,h,w] and trunc_in a float32 trunc
// plane or null (then trunc is not written).
template <bool kPacked, typename XyzT>
__global__ void __launch_bounds__(kLabelThreads)
gt_labels_kernel(const void* __restrict__ mask,
                 const float* __restrict__ trunc_in,
                 const XyzT* __restrict__ xyz,
                 const float* __restrict__ center,
                 const float* __restrict__ scale,
                 const float* __restrict__ fps,
                 const float* __restrict__ rot,
                 const float* __restrict__ extent,
                 float* __restrict__ visib, float* __restrict__ obj,
                 float* __restrict__ trunc, int* __restrict__ region,
                 float* __restrict__ coord, int h, int w, int out, int K,
                 int residual) {
  __shared__ float4 sf[kMaxK];
  __shared__ float sr[9];
  __shared__ float se[3];
  __shared__ float sc[3];                  // centre x, centre y, r
  const int b = blockIdx.y;
  const int p = blockIdx.x * kLabelThreads + threadIdx.x;
  stage_roi(fps, rot, extent, b, K, sf, sr, se);
  if (threadIdx.x < 2) sc[threadIdx.x] = center[(size_t)b * 2 + threadIdx.x];
  if (threadIdx.x == 2) sc[2] = __fdiv_rn(scale[b], (float)out);
  __syncthreads();
  if (p >= out * out) return;

  // source coordinate of output pixel (i, j), as ops/warp._src_coords
  const int i = p / out, j = p - i * out;
  const float half_out = 0.5f * (float)out;
  const float sx = __fadd_rn(sc[0], __fmul_rn(__fsub_rn((float)j, half_out),
                                              sc[2]));
  const float sy = __fadd_rn(sc[1], __fmul_rn(__fsub_rn((float)i, half_out),
                                              sc[2]));
  const float fx = rintf(sx), fy = rintf(sy);   // half to even
  const float valid = (fx >= 0.f && fx < (float)w && fy >= 0.f &&
                       fy < (float)h) ? 1.f : 0.f;
  const int ix = (int)fminf(fmaxf(fx, 0.f), (float)(w - 1));
  const int iy = (int)fminf(fmaxf(fy, 0.f), (float)(h - 1));
  const size_t src = ((size_t)b * h + iy) * w + ix;

  const float x0 = load_xyz(xyz, src * 3 + 0);
  const float y0 = load_xyz(xyz, src * 3 + 1);
  const float z0 = load_xyz(xyz, src * 3 + 2);
  const float ob = (x0 != 0.f || y0 != 0.f || z0 != 0.f) ? 1.f : 0.f;
  float v, t = 0.f;
  if (kPacked) {
    const unsigned char m = __ldg(static_cast<const unsigned char*>(mask)
                                  + src);
    v = (float)(m & 1);
    t = (float)((m >> 1) & 1);
  } else {
    v = __ldg(static_cast<const float*>(mask) + src);
    if (trunc_in != nullptr) t = __ldg(trunc_in + src);
  }

  // the plain version multiplies each gathered plane by the tap's validity
  const size_t pix = (size_t)b * out * out + p;
  visib[pix] = __fmul_rn(__fmul_rn(v, ob), valid);
  obj[pix] = __fmul_rn(ob, valid);
  if (trunc != nullptr) trunc[pix] = __fmul_rn(__fmul_rn(t, ob), valid);
  const float x = __fmul_rn(x0, valid);
  const float y = __fmul_rn(y0, valid);
  const float z = __fmul_rn(z0, valid);
  if (residual) {
    label_pixel(sf, sr, se, K, x, y, z, region + pix, coord + pix * 3);
  } else {
    const int arg = nearest_keypoint(sf, K, x, y, z);
    region[pix] = (x != 0.f || y != 0.f || z != 0.f) ? arg + 1 : 0;
    coord[pix * 3 + 0] = __fadd_rn(__fdiv_rn(x, se[0]), 0.5f);
    coord[pix * 3 + 1] = __fadd_rn(__fdiv_rn(y, se[1]), 0.5f);
    coord[pix * 3 + 2] = __fadd_rn(__fdiv_rn(z, se[2]), 0.5f);
  }
}

template <bool kPacked, typename XyzT>
void launch_gt_labels(dim3 grid, cudaStream_t stream, const void* mask,
                      const float* trunc_in, const void* xyz,
                      const float* center, const float* scale,
                      const float* fps, const float* rot,
                      const float* extent, float* visib, float* obj,
                      float* trunc, int* region, float* coord, int h, int w,
                      int out, int K, int residual) {
  gt_labels_kernel<kPacked, XyzT><<<grid, kLabelThreads, 0, stream>>>(
      mask, trunc_in, static_cast<const XyzT*>(xyz), center, scale, fps, rot,
      extent, visib, obj, trunc, region, coord, h, w, out, K, residual);
}

}  // namespace

extern "C" {

int region_label_max_k() { return kMaxK; }

int gt_labels_max_k() { return kMaxK; }

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
int region_label_launch(const float* xyz, const float* fps, const float* rot,
                        const float* extent, int* region, float* coord,
                        int B, int N, int K, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (K <= 0 || K > kMaxK) return (int)cudaErrorInvalidValue;
  dim3 grid((N + kThreads - 1) / kThreads, B);
  region_label_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xyz, fps, rot, extent, region, coord, N, K);
  return (int)cudaGetLastError();
}

// packed != 0: mask is uint8 packed bits (trunc_in ignored, trunc written);
// else float32 visib, trunc_in and trunc both null or both given.
// xyz_half != 0: xyz is float16, else float32. Returns cudaGetLastError().
int gt_labels_launch(const void* mask, const float* trunc_in, int packed,
                     const void* xyz, int xyz_half, const float* center,
                     const float* scale, const float* fps, const float* rot,
                     const float* extent, float* visib, float* obj,
                     float* trunc, int* region, float* coord, int B, int h,
                     int w, int out, int K, int residual, void* stream) {
  if (B <= 0 || out <= 0) return 0;
  if (K <= 0 || K > kMaxK || h <= 0 || w <= 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((out * out + kLabelThreads - 1) / kLabelThreads, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (packed && xyz_half)
    launch_gt_labels<true, __half>(grid, s, mask, trunc_in, xyz, center,
                                   scale, fps, rot, extent, visib, obj, trunc,
                                   region, coord, h, w, out, K, residual);
  else if (packed)
    launch_gt_labels<true, float>(grid, s, mask, trunc_in, xyz, center, scale,
                                  fps, rot, extent, visib, obj, trunc, region,
                                  coord, h, w, out, K, residual);
  else if (xyz_half)
    launch_gt_labels<false, __half>(grid, s, mask, trunc_in, xyz, center,
                                    scale, fps, rot, extent, visib, obj,
                                    trunc, region, coord, h, w, out, K,
                                    residual);
  else
    launch_gt_labels<false, float>(grid, s, mask, trunc_in, xyz, center,
                                   scale, fps, rot, extent, visib, obj, trunc,
                                   region, coord, h, w, out, K, residual);
  return (int)cudaGetLastError();
}

const char* region_label_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
