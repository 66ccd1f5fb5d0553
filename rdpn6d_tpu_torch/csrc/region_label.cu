// region_label: RDPN's train labels. For each pixel of a cropped
// object-frame xyz map, the nearest FPS keypoint (region 1..K, 0 at the
// background, where xyz = 0) and the normalized camera-rotated residual
//     coord = R (xyz - fps[nearest]) / extent + 0.5,
// batched over ROIs. xyz [B,N,3] (N = H*W), fps [B,K,3], R [B,3,3],
// extent [B,3], all float32 -> region [B,N] int32, coord [B,N,3] float32.
//
// Replaces the TPU path's MXU rewrite in rdpn6d_tpu/ops/region.py:21-74
// (xyz_to_region + residual_coord_target; no Pallas kernel): distances as
// |x|^2 - 2 x.f + |f|^2 with the cross term an einsum at
// precision="highest", a jnp.argmin, a take_along_axis gather and a second
// einsum for the rotation, each a separate pass over [B,H,W,K] or [B,H,W,3].
//
// Design for Hopper:
//  * Grid (ceil(N/256), B), 256 threads a block, one thread a pixel. The
//    ROI's keypoints (as float4), R and extent are staged once per block in
//    shared memory; every thread of a warp reads the same keypoint at once
//    (a broadcast, no bank conflict). Nothing is padded: the last block
//    masks its tail.
//  * The distance is the direct form sum_d (x_d - f_d)^2 in true float32,
//    with __fsub_rn/__fmul_rn/__fadd_rn so that nvcc contracts nothing into
//    FMAs: the sum rounds exactly as the plain PyTorch version's
//    ((dx^2 + dy^2) + dz^2), and the two pick the same keypoint. The
//    expanded form would cancel for points ~0.1 m from the origin.
//  * Ties go to the lowest index, as jnp.argmin and torch.argmin do: a
//    strict < in ascending k.
//  * Background pixels still get a coordinate: their nearest keypoint is
//    the one nearest the origin, and the JAX package emits that too.
//  * Bound: bytes. Per pixel 12 B of xyz in, 4 B of region and 12 B of
//    coord out, 28 B; per (pixel, keypoint) ~7 FP32 instructions. At the
//    train shape (24 ROIs of 64x64, K = 32) that is 2.75 MB, ~0.82 us at
//    3.35 TB/s, against 22e6 instructions, ~0.66 us at 33.5e12/s. A launch
//    this small is dominated by its fixed cost; this PR does not tune it.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 64;

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
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const float* f = fps + ((size_t)b * K + k) * 3;
    sf[k] = make_float4(f[0], f[1], f[2], 0.f);
  }
  if (threadIdx.x < 9) sr[threadIdx.x] = rot[(size_t)b * 9 + threadIdx.x];
  if (threadIdx.x < 3) se[threadIdx.x] = extent[(size_t)b * 3 + threadIdx.x];
  __syncthreads();
  if (p >= N) return;

  const size_t pix = (size_t)b * N + p;
  const float x = xyz[pix * 3 + 0];
  const float y = xyz[pix * 3 + 1];
  const float z = xyz[pix * 3 + 2];
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
  const bool fg = (x != 0.f) || (y != 0.f) || (z != 0.f);
  region[pix] = fg ? arg + 1 : 0;

  const float4 f = sf[arg];
  const float dx = x - f.x, dy = y - f.y, dz = z - f.z;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float r = sr[3 * i] * dx + sr[3 * i + 1] * dy + sr[3 * i + 2] * dz;
    coord[pix * 3 + i] = r / se[i] + 0.5f;
  }
}

}  // namespace

extern "C" {

int region_label_max_k() { return kMaxK; }

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

const char* region_label_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
