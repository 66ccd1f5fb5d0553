// min_dist2: for each row of a, the minimum over the rows of b of |a - b|^2,
// batched over a leading ROI axis. a [B,N,D], b [B,M,D] float32 -> out [B,N].
//
// Replaces the TPU kernel rdpn6d_tpu/ops/pallas_kernels.py:min_dist2_pallas
// (body _min_dist_kernel), the pairwise reduction behind ADI
// (evaluation/pose_error.adi). The Pallas kernel keeps a 256-row A tile in
// VMEM, streams B through in 512-row chunks padded with 1e9 sentinel rows,
// and forms |a|^2 - 2 a.b + |b|^2 with the cross term on the MXU.
//
// Design for Hopper:
//  * Grid (ceil(N/128), B), 128 threads a block. Each thread owns one a-row,
//    kept in registers, and a running minimum in a register. The block
//    stages b through shared memory in chunks of kChunk rows; every thread
//    of a warp reads the same b-row at once (a broadcast, no bank conflict).
//  * Ragged edges are masked: rows of a past N only help to stage b, chunk
//    loops stop at M. Nothing is padded and no sentinel is needed.
//  * Arithmetic is the direct form sum_d (a_d - b_d)^2 in true float32 (no
//    TF32, no tensor cores). With D = 3 a tensor-core GEMM buys nothing: the
//    contraction is 3 deep. And the expanded form cancels badly for points
//    ~1 m from the camera: at |a|^2 ~ 1 an ulp is ~1e-7 m^2, ~0.3 mm after
//    the square root, while ADI thresholds are a few mm.
//  * Bound: compute. Per pair 3 subtractions, 3 multiply-adds and a min,
//    ~7 FP32 instructions; B=16 ROIs of 4096 x 4096 points are ~1.9e9 of
//    them, ~0.06 ms at 132 SMs x 128 lanes x 1.98 GHz. The bytes moved
//    (2 x 16 x 4096 x 12 B in, 16 x 4096 x 4 B out) take ~0.5 us.
//  * D is a runtime argument; D = 3 takes a path that stages b as float4
//    (one 16-byte shared load a pair), any other D <= kMaxD a generic one.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 512;
constexpr int kMaxD = 8;

__global__ void __launch_bounds__(kThreads)
min_dist2_d3(const float* __restrict__ a, const float* __restrict__ b,
             float* __restrict__ out, int N, int M) {
  __shared__ float4 sb[kChunk];
  const int batch = blockIdx.y;
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const float* ab = a + (size_t)batch * N * 3;
  const float* bb = b + (size_t)batch * M * 3;
  float ax = 0.f, ay = 0.f, az = 0.f;
  if (row < N) {
    ax = ab[row * 3 + 0];
    ay = ab[row * 3 + 1];
    az = ab[row * 3 + 2];
  }
  float best = CUDART_INF_F;
  for (int base = 0; base < M; base += kChunk) {
    const int rows = min(kChunk, M - base);
    __syncthreads();  // the previous chunk is no longer read
    for (int j = threadIdx.x; j < rows; j += kThreads) {
      const float* p = bb + (size_t)(base + j) * 3;
      sb[j] = make_float4(p[0], p[1], p[2], 0.f);
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < rows; ++j) {
      const float4 q = sb[j];
      const float dx = ax - q.x, dy = ay - q.y, dz = az - q.z;
      best = fminf(best, dx * dx + dy * dy + dz * dz);
    }
  }
  if (row < N) out[(size_t)batch * N + row] = best;
}

__global__ void __launch_bounds__(kThreads)
min_dist2_generic(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ out, int N, int M, int D) {
  __shared__ float sb[kChunk * kMaxD];
  const int batch = blockIdx.y;
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const float* ab = a + (size_t)batch * N * D;
  const float* bb = b + (size_t)batch * M * D;
  float av[kMaxD];
#pragma unroll
  for (int d = 0; d < kMaxD; ++d)
    av[d] = (row < N && d < D) ? ab[(size_t)row * D + d] : 0.f;
  float best = CUDART_INF_F;
  for (int base = 0; base < M; base += kChunk) {
    const int rows = min(kChunk, M - base);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * D; i += kThreads)
      sb[i] = bb[(size_t)base * D + i];
    __syncthreads();
    for (int j = 0; j < rows; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < kMaxD; ++d) {
        if (d < D) {
          const float t = av[d] - sb[j * D + d];
          s += t * t;
        }
      }
      best = fminf(best, s);
    }
  }
  if (row < N) out[(size_t)batch * N + row] = best;
}

}  // namespace

extern "C" {

int min_dist2_max_d() { return kMaxD; }

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
int min_dist2_launch(const float* a, const float* b, float* out, int B,
                     int N, int M, int D, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (M <= 0 || D <= 0 || D > kMaxD) return (int)cudaErrorInvalidValue;
  dim3 grid((N + kThreads - 1) / kThreads, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 3)
    min_dist2_d3<<<grid, kThreads, 0, s>>>(a, b, out, N, M);
  else
    min_dist2_generic<<<grid, kThreads, 0, s>>>(a, b, out, N, M, D);
  return (int)cudaGetLastError();
}

const char* min_dist2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
