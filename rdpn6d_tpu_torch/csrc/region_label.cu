// RDPN's train labels, three entry points.
//
// region_label: for each pixel of a cropped object-frame xyz map, the
// nearest FPS keypoint (region 1..K, 0 at the background, where xyz = 0)
// and the normalized camera-rotated residual
//     coord = R (xyz - fps[nearest]) / extent + 0.5,
// batched over ROIs. xyz [B,N,3] (N = H*W), fps [B,K,3], R [B,3,3],
// extent [B,3], all float32 -> region [B,N] int32, coord [B,N,3] float32.
// ops/region.residual_coord_target and xyz_to_region call it.
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
// surface_labels: the same labels for a split that ships no GT xyz map
// (BOP-PBR), from the depth surface. For each ROI's out x out label crop,
// the nearest taps of its frame's depth (float32 [F,h,w], frame_idx [B]
// int64) and of its full-frame masks (as gt_labels'), then
//     m = (depth > 1e-6) * visib,  p = ((u - cx) d / fx, (v - cy) d / fy, d)
// with (u, v) the tap's own pixel (0 off the frame) and K the ROI's
// [B,3,3] intrinsics, xyz = R^T (p - t) * m, and the region id and coord
// of xyz as above. -> m [B,o,o] (the visib and obj mask both), trunc * m
// (with a trunc plane), region, coord.
//
// Replaces the TPU path's MXU rewrites (no Pallas kernel):
// rdpn6d_tpu/ops/region.py:21-74 (xyz_to_region + residual_coord_target:
// distances as |x|^2 - 2 x.f + |f|^2 with the cross term an einsum at
// precision="highest", an argmin, a gather and a second einsum) and, for
// gt_labels, also rdpn6d_tpu/data/pipeline.py:197-221, the nearest crop
// of the stacked mask and xyz planes as 0/1 selection-matrix matmuls
// (rdpn6d_tpu/ops/warp.py:115 _select_matrix, :130 crop_resize_mm);
// surface_labels replaces rdpn6d_tpu/data/pipeline.py:222-251, the nearest
// crop of the stacked [visib, depth, u, v(, trunc)] planes, the
// back-projection and the rotation (an einsum), before the labels.
//
// Design for Hopper:
//  * One thread an output pixel; R, extent (and, for gt_labels, centre
//    and r = scale / out) are staged once per block in shared memory, the
//    ROI's keypoints (as float4) in tiles of kTileK = 64, one tile at a
//    time, so any number of keypoints fits; every thread of a warp reads
//    the same keypoint at once (a broadcast, no bank conflict). Each
//    kernel comes in two instantiations. K <= kTileK (lm13's 32) takes
//    the untiled one: all keypoints go in with R and extent before the
//    block's one barrier, and the last block of a ROI drops its tail
//    threads after it. Larger K takes the tiled one: each further tile
//    costs two barriers, and the tail threads stay to the last of them.
//    One instantiation with the same tests on K at run time takes 34
//    registers, not 32, and runs gt_labels at K = 32 7% slower (4.71 us
//    against 4.38 us of device time, time_labels.py on an H100 80GB HBM3
//    at 700 W).
//  * The distance is the direct form sum_d (x_d - f_d)^2 in true float32,
//    with __fsub_rn/__fmul_rn/__fadd_rn so that nvcc contracts nothing into
//    FMAs: the sum rounds exactly as the plain PyTorch version's
//    ((dx^2 + dy^2) + dz^2), and the two pick the same keypoint. The
//    expanded (GEMM) form would cancel for points ~0.1 m from the origin,
//    so the tensor cores are not used.
//  * Ties go to the lowest index, as jnp.argmin and torch.argmin do: a
//    strict < in ascending k, across tiles too.
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
//  * surface_labels takes the same taps (the mask at the ROI's own plane,
//    the depth at its frame's, both cropped with the ROI's centre: the
//    masks are full frames here, so no offset applies) and never builds
//    the plain version's float32 mask planes, their stacked copy or the
//    full-frame (u, v) grid. The ROI's K, t, R, extent, centre and r are
//    staged once per block. Every op of the back-projection and of the
//    rotation R^T (p - t), ((a0 R0k + a1 R1k) + a2 R2k), is a _rn
//    intrinsic in the plain version's order, and so is the residual's
//    rotation R (xyz - f): xyz, hence every region id and coordinate, is
//    the plain version's bit for bit, where one contracted FMA could flip
//    a near-tie. Background pixels keep the keypoint search: their xyz is
//    +-0 and their coordinate comes from the keypoint nearest the origin.
//  * Bound: bytes. region_label moves 28 B a pixel (12 in, 16 out);
//    gt_labels 35 B with packed masks and float16 xyz (1 + 6 in, 3 x 4 of
//    masks + 4 of region + 12 of coord out), 3.44 MB at the train shape
//    (24 ROIs of 64x64, K = 32), ~1.03 us at 3.35 TB/s, against ~22e6
//    FP32 instructions, ~0.66 us at 33.5e12/s; surface_labels 29 B with
//    packed masks (4 of depth + 1 in, 2 x 4 of masks + 4 + 12 out), 2.85
//    MB, ~0.85 us, against the same ~22e6 instructions. A launch this
//    small is dominated by its fixed cost; taking the crop's launches
//    into it (a dozen for gt_labels, ~90 for the depth surface's chain)
//    is the gain this design goes for.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLabelThreads = 128;
constexpr int kTileK = 64;      // keypoints staged at a time

// Stages the ROI's R and extent in shared memory (callers __syncthreads()
// before reading them).
__device__ __forceinline__ void stage_roi(const float* __restrict__ rot,
                                          const float* __restrict__ extent,
                                          int b, float* sr, float* se) {
  if (threadIdx.x < 9) sr[threadIdx.x] = rot[(size_t)b * 9 + threadIdx.x];
  if (threadIdx.x < 3) se[threadIdx.x] = extent[(size_t)b * 3 + threadIdx.x];
}

// Stages keypoints k0 .. k0 + kTileK - 1 (those below K) of ROI b in `sf`.
__device__ __forceinline__ void stage_tile(const float* __restrict__ fps,
                                           int b, int K, int k0, float4* sf) {
  const int n = min(kTileK, K - k0);
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const float* f = fps + ((size_t)b * K + k0 + k) * 3;
    sf[k] = make_float4(f[0], f[1], f[2], 0.f);
  }
}

// Folds keypoints k0 .. k0 + n - 1, staged in `sf`, into the running
// nearest (best, arg): the direct form without FMA contraction, a strict <
// so the first minimum wins.
__device__ __forceinline__ void nearest_in_tile(const float4* sf, int n,
                                                int k0, float x, float y,
                                                float z, float& best,
                                                int& arg) {
  for (int k = 0; k < n; ++k) {
    const float4 f = sf[k];
    const float dx = __fsub_rn(x, f.x);
    const float dy = __fsub_rn(y, f.y);
    const float dz = __fsub_rn(z, f.z);
    const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                              __fmul_rn(dz, dz));
    if (d < best) {
      best = d;
      arg = k0 + k;
    }
  }
}

// Index of the nearest of the ROI's K keypoints, first minimum on ties.
// kTiled false: all K <= kTileK keypoints were staged in `sf` before the
// block's barrier. kTiled true: the first tile was; the later ones pass
// through `sf` here, so every thread of the block calls this, `active`
// false for a thread past the ROI's last pixel.
template <bool kTiled>
__device__ __forceinline__ int nearest_keypoint(const float* __restrict__ fps,
                                                int b, int K, float4* sf,
                                                bool active, float x, float y,
                                                float z) {
  float best = CUDART_INF_F;
  int arg = 0;
  if (!kTiled) {
    nearest_in_tile(sf, K, 0, x, y, z, best, arg);
    return arg;
  }
  for (int k0 = 0;;) {
    if (active)
      nearest_in_tile(sf, min(kTileK, K - k0), k0, x, y, z, best, arg);
    k0 += kTileK;
    if (k0 >= K) break;
    __syncthreads();                       // the block is done with a tile
    stage_tile(fps, b, K, k0, sf);
    __syncthreads();
  }
  return arg;
}

// region (0 at the background) and coord = R (xyz - f) / extent + 0.5, f
// the nearest keypoint `arg`: in `sf` when all K are one tile, else read
// from global memory. kExact: every op rounded on its own, R's row summed
// left to right, as surface_labels' plain version does.
template <bool kTiled, bool kExact = false>
__device__ __forceinline__ void label_pixel(const float* __restrict__ fps,
                                            const float4* sf, const float* sr,
                                            const float* se, int b, int K,
                                            int arg, float x, float y,
                                            float z, int* region,
                                            float* coord) {
  const bool fg = (x != 0.f) || (y != 0.f) || (z != 0.f);
  *region = fg ? arg + 1 : 0;
  float4 f;
  if (!kTiled) {
    f = sf[arg];
  } else {
    const float* g = fps + ((size_t)b * K + arg) * 3;
    f = make_float4(__ldg(g), __ldg(g + 1), __ldg(g + 2), 0.f);
  }
  const float dx = x - f.x, dy = y - f.y, dz = z - f.z;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (kExact) {
      const float r = __fadd_rn(__fadd_rn(__fmul_rn(sr[3 * i], dx),
                                          __fmul_rn(sr[3 * i + 1], dy)),
                                __fmul_rn(sr[3 * i + 2], dz));
      coord[i] = __fadd_rn(__fdiv_rn(r, se[i]), 0.5f);
    } else {
      const float r = sr[3 * i] * dx + sr[3 * i + 1] * dy
          + sr[3 * i + 2] * dz;
      coord[i] = r / se[i] + 0.5f;
    }
  }
}

template <bool kTiled>
__global__ void __launch_bounds__(kThreads)
region_label_kernel(const float* __restrict__ xyz,
                    const float* __restrict__ fps,
                    const float* __restrict__ rot,
                    const float* __restrict__ extent,
                    int* __restrict__ region, float* __restrict__ coord,
                    int N, int K) {
  __shared__ float4 sf[kTileK];
  __shared__ float sr[9];
  __shared__ float se[3];
  const int b = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  // the keypoints first: the scalar loads of R and extent then overlap
  // the tile's
  stage_tile(fps, b, K, 0, sf);
  stage_roi(rot, extent, b, sr, se);
  __syncthreads();
  const bool active = p < N;
  if (!kTiled && !active) return;          // no barrier follows

  const size_t pix = (size_t)b * N + (active ? p : 0);
  const float x = xyz[pix * 3 + 0];
  const float y = xyz[pix * 3 + 1];
  const float z = xyz[pix * 3 + 2];
  const int arg = nearest_keypoint<kTiled>(fps, b, K, sf, active, x, y, z);
  if (!active) return;
  label_pixel<kTiled>(fps, sf, sr, se, b, K, arg, x, y, z, region + pix,
                      coord + pix * 3);
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
template <bool kPacked, typename XyzT, bool kTiled>
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
  __shared__ float4 sf[kTileK];
  __shared__ float sr[9];
  __shared__ float se[3];
  __shared__ float sc[3];                  // centre x, centre y, r
  const int b = blockIdx.y;
  const int p = blockIdx.x * kLabelThreads + threadIdx.x;
  stage_tile(fps, b, K, 0, sf);
  stage_roi(rot, extent, b, sr, se);
  if (threadIdx.x < 2) sc[threadIdx.x] = center[(size_t)b * 2 + threadIdx.x];
  if (threadIdx.x == 2) sc[2] = __fdiv_rn(scale[b], (float)out);
  __syncthreads();
  const bool active = p < out * out;
  if (!kTiled && !active) return;          // no barrier follows

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
  // in the map whatever the tap: a thread past the ROI's last pixel reads
  // a clamped one and stores nothing
  const size_t src = ((size_t)b * h + iy) * w + ix;

  const float x0 = load_xyz(xyz, src * 3 + 0);
  const float y0 = load_xyz(xyz, src * 3 + 1);
  const float z0 = load_xyz(xyz, src * 3 + 2);
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
  const float ob = (x0 != 0.f || y0 != 0.f || z0 != 0.f) ? 1.f : 0.f;

  // the plain version multiplies each gathered plane by the tap's validity
  const size_t pix = (size_t)b * out * out + p;
  if (active) {
    visib[pix] = __fmul_rn(__fmul_rn(v, ob), valid);
    obj[pix] = __fmul_rn(ob, valid);
    if (trunc != nullptr) trunc[pix] = __fmul_rn(__fmul_rn(t, ob), valid);
  }
  const float x = __fmul_rn(x0, valid);
  const float y = __fmul_rn(y0, valid);
  const float z = __fmul_rn(z0, valid);
  if (residual) {
    const int arg = nearest_keypoint<kTiled>(fps, b, K, sf, active, x, y, z);
    if (active)
      label_pixel<kTiled>(fps, sf, sr, se, b, K, arg, x, y, z, region + pix,
                          coord + pix * 3);
  } else {
    const int arg = nearest_keypoint<kTiled>(fps, b, K, sf, active, x, y, z);
    if (active) {
      region[pix] = (x != 0.f || y != 0.f || z != 0.f) ? arg + 1 : 0;
      coord[pix * 3 + 0] = __fadd_rn(__fdiv_rn(x, se[0]), 0.5f);
      coord[pix * 3 + 1] = __fadd_rn(__fdiv_rn(y, se[1]), 0.5f);
      coord[pix * 3 + 2] = __fadd_rn(__fdiv_rn(z, se[2]), 0.5f);
    }
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
  if (K <= kTileK)
    gt_labels_kernel<kPacked, XyzT, false><<<grid, kLabelThreads, 0, stream>>>(
        mask, trunc_in, static_cast<const XyzT*>(xyz), center, scale, fps,
        rot, extent, visib, obj, trunc, region, coord, h, w, out, K,
        residual);
  else
    gt_labels_kernel<kPacked, XyzT, true><<<grid, kLabelThreads, 0, stream>>>(
        mask, trunc_in, static_cast<const XyzT*>(xyz), center, scale, fps,
        rot, extent, visib, obj, trunc, region, coord, h, w, out, K,
        residual);
}

// kPacked: mask is uint8 [B,h,w], visib = bit 0, trunc = bit 1. Otherwise
// float32 visib [B,h,w] and trunc_in a float32 plane or null (then trunc
// is not written). depth [F,h,w], cam [B,3,3] (the ROI's K), trans [B,3].
template <bool kPacked, bool kTiled>
__global__ void __launch_bounds__(kLabelThreads)
surface_labels_kernel(const float* __restrict__ depth,
                      const long long* __restrict__ frame_idx,
                      const void* __restrict__ mask,
                      const float* __restrict__ trunc_in,
                      const float* __restrict__ cam,
                      const float* __restrict__ center,
                      const float* __restrict__ scale,
                      const float* __restrict__ fps,
                      const float* __restrict__ rot,
                      const float* __restrict__ trans,
                      const float* __restrict__ extent,
                      float* __restrict__ m_out, float* __restrict__ trunc,
                      int* __restrict__ region, float* __restrict__ coord,
                      int F, int h, int w, int out, int K, int residual) {
  __shared__ float4 sf[kTileK];
  __shared__ float sr[9];
  __shared__ float se[3];
  __shared__ float sc[3];                  // centre x, centre y, r
  __shared__ float sk[4];                  // fx, fy, cx, cy
  __shared__ float st[3];                  // t
  __shared__ long long sfr;                // the ROI's frame
  const int b = blockIdx.y;
  const int p = blockIdx.x * kLabelThreads + threadIdx.x;
  stage_tile(fps, b, K, 0, sf);
  stage_roi(rot, extent, b, sr, se);
  const int s = (int)threadIdx.x - 32;     // the second warp: the scalars
  if (s >= 0 && s < 2) sc[s] = center[(size_t)b * 2 + s];
  if (s == 2) sc[2] = __fdiv_rn(scale[b], (float)out);
  if (s >= 3 && s < 7)    // K[0][0], K[1][1], K[0][2], K[1][2]
    sk[s - 3] = cam[(size_t)b * 9 + (s < 5 ? 4 * (s - 3) : 3 * s - 13)];
  if (s >= 7 && s < 10) st[s - 7] = trans[(size_t)b * 3 + s - 7];
  // staged with the rest, so that the depth tap's load does not wait on
  // a load of its own frame index after the barrier
  if (s == 10) sfr = frame_idx[b];
  __syncthreads();
  const bool active = p < out * out;
  if (!kTiled && !active) return;          // no barrier follows
  const long long f = sfr;
  if (f < 0 || f >= F) __trap();           // as an index assert would

  // the tap, as ops/warp._src_coords and gt_labels take it
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
  const size_t tap = (size_t)iy * w + ix;
  const size_t src = (size_t)b * h * w + tap;   // in the ROI's mask plane

  // the plain version gathers each plane and multiplies it by validity
  const float d = __fmul_rn(__ldg(depth + (size_t)f * h * w + tap), valid);
  float v, t = 0.f;
  if (kPacked) {
    const unsigned char mb = __ldg(static_cast<const unsigned char*>(mask)
                                   + src);
    v = (float)(mb & 1);
    t = (float)((mb >> 1) & 1);
  } else {
    v = __ldg(static_cast<const float*>(mask) + src);
    if (trunc_in != nullptr) t = __ldg(trunc_in + src);
  }
  const float m = __fmul_rn(d > 1e-6f ? 1.f : 0.f, __fmul_rn(v, valid));
  const float u = __fmul_rn((float)ix, valid);
  const float vv = __fmul_rn((float)iy, valid);
  // a = p - t; xyz_k = ((a0 R0k + a1 R1k) + a2 R2k) * m, each op rounded
  const float a0 = __fsub_rn(__fdiv_rn(__fmul_rn(__fsub_rn(u, sk[2]), d),
                                       sk[0]), st[0]);
  const float a1 = __fsub_rn(__fdiv_rn(__fmul_rn(__fsub_rn(vv, sk[3]), d),
                                       sk[1]), st[1]);
  const float a2 = __fsub_rn(d, st[2]);
  float q[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    q[k] = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(a0, sr[k]),
                                         __fmul_rn(a1, sr[3 + k])),
                               __fmul_rn(a2, sr[6 + k])), m);

  const size_t pix = (size_t)b * out * out + p;
  if (active) {
    m_out[pix] = m;
    if (trunc != nullptr) trunc[pix] = __fmul_rn(__fmul_rn(t, valid), m);
  }
  const int arg = nearest_keypoint<kTiled>(fps, b, K, sf, active, q[0], q[1],
                                           q[2]);
  if (!active) return;
  if (residual) {
    label_pixel<kTiled, true>(fps, sf, sr, se, b, K, arg, q[0], q[1], q[2],
                              region + pix, coord + pix * 3);
  } else {
    region[pix] = (q[0] != 0.f || q[1] != 0.f || q[2] != 0.f) ? arg + 1 : 0;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      coord[pix * 3 + k] = __fadd_rn(__fdiv_rn(q[k], se[k]), 0.5f);
  }
}

template <bool kPacked>
void launch_surface_labels(dim3 grid, cudaStream_t stream, const float* depth,
                           const long long* frame_idx, const void* mask,
                           const float* trunc_in, const float* cam,
                           const float* center, const float* scale,
                           const float* fps, const float* rot,
                           const float* trans, const float* extent,
                           float* m, float* trunc, int* region, float* coord,
                           int F, int h, int w, int out, int K,
                           int residual) {
  if (K <= kTileK)
    surface_labels_kernel<kPacked, false><<<grid, kLabelThreads, 0, stream>>>(
        depth, frame_idx, mask, trunc_in, cam, center, scale, fps, rot,
        trans, extent, m, trunc, region, coord, F, h, w, out, K, residual);
  else
    surface_labels_kernel<kPacked, true><<<grid, kLabelThreads, 0, stream>>>(
        depth, frame_idx, mask, trunc_in, cam, center, scale, fps, rot,
        trans, extent, m, trunc, region, coord, F, h, w, out, K, residual);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
int region_label_launch(const float* xyz, const float* fps, const float* rot,
                        const float* extent, int* region, float* coord,
                        int B, int N, int K, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (K <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((N + kThreads - 1) / kThreads, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= kTileK)
    region_label_kernel<false><<<grid, kThreads, 0, s>>>(
        xyz, fps, rot, extent, region, coord, N, K);
  else
    region_label_kernel<true><<<grid, kThreads, 0, s>>>(
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
  if (K <= 0 || h <= 0 || w <= 0)
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

// packed != 0: mask is uint8 packed bits (trunc_in ignored, trunc written);
// else float32 visib, trunc_in and trunc both null or both given.
// frame_idx int64 [B], each in [0, F). Returns cudaGetLastError().
int surface_labels_launch(const float* depth, const long long* frame_idx,
                          const void* mask, const float* trunc_in,
                          int packed, const float* cam, const float* center,
                          const float* scale, const float* fps,
                          const float* rot, const float* trans,
                          const float* extent, float* m, float* trunc,
                          int* region, float* coord, int B, int F, int h,
                          int w, int out, int K, int residual,
                          void* stream) {
  if (B <= 0 || out <= 0) return 0;
  if (K <= 0 || F <= 0 || h <= 0 || w <= 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((out * out + kLabelThreads - 1) / kLabelThreads, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (packed)
    launch_surface_labels<true>(grid, s, depth, frame_idx, mask, trunc_in,
                                cam, center, scale, fps, rot, trans, extent,
                                m, trunc, region, coord, F, h, w, out, K,
                                residual);
  else
    launch_surface_labels<false>(grid, s, depth, frame_idx, mask, trunc_in,
                                 cam, center, scale, fps, rot, trans, extent,
                                 m, trunc, region, coord, F, h, w, out, K,
                                 residual);
  return (int)cudaGetLastError();
}

const char* region_label_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
