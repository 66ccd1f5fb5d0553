// min_dist2: for each row of a, the minimum over the rows of b of |a - b|^2,
// batched over a leading ROI axis. a [B,N,D], b [B,M,D] float32 -> out [B,N].
//
// Replaces the TPU kernel rdpn6d_tpu/ops/pallas_kernels.py:57
// min_dist2_pallas (body _min_dist_kernel, :29), the pairwise reduction
// behind ADI (evaluation/pose_error.adi). The Pallas kernel keeps a 256-row
// A tile in VMEM, streams B through in 512-row chunks padded with 1e9
// sentinel rows, and forms |a|^2 - 2 a.b + |b|^2 with the cross term on the
// MXU.
//
// Arithmetic. The direct form sum_d (a_d - b_d)^2 in true float32 (no TF32,
// no tensor cores), written out as
// __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx))) of __fsub_rn
// differences, so a pair's value does not depend on how nvcc schedules the
// tiled loop and every path of the kernel gives the same bits. With D = 3 a
// tensor-core GEMM buys nothing (the contraction is 3 deep), and the
// expanded form cancels for points ~1 m from the camera: at |a|^2 ~ 1 an ulp
// is ~1e-7 m^2, ~0.3 mm after the square root, while ADI thresholds are a
// few mm. The min is PTX min.NaN.f32: a NaN distance makes its row's result
// NaN, as torch.amin and jnp.min do (fminf would return the other operand).
// The min is exact, so the result does not depend on how b is split.
//
// Bound: operations. A pair costs 7 FP32 instructions (3 subtractions, a
// multiply, 2 multiply-adds, a min), and the card issues 132 SMs x 128
// lanes x 1.98 GHz = 33.5e12 of them a second: 0.056 ms for 16 x 4096 x
// 4096 pairs (serve + score), 0.015 ms for 8 x 3000 x 3000 (the largest
// per-object launch of the eval smoke), 1.88 ms for 1000 x 3000 x 3000 (one
// object of LM-13's test split). The bytes (each input read once, the
// output written once) take under 2% of that at each of these shapes.
//
// Design. The wrapper's launch plan (ops/min_dist.launch_plan, a pure
// function of B, N, M, D and the SM count) sets the grid; this file checks
// that the plan is one it implements.
//  * Register tiling (the old kernel spent a shared load on every pair, and
//    the load competes with the pair's 7 FP32 instructions for issue). A
//    thread owns kRows a-rows and their running minima in registers, so a
//    b-row read from shared memory (a broadcast: the warp reads one address)
//    feeds kRows pairs. b lies in shared memory as it does in device memory,
//    12 B a row, so four rows are three 16-byte loads: 3 loads feed
//    4 x kRows pairs, and the issue ceiling is 28 kRows / (28 kRows + 3).
//  * A grid sized to the card (the old grid, one a-row a thread, gave the
//    eval's 8 x 3000 a-rows 192 blocks: 1-2 blocks, 4-8 warps, an SM). A
//    block covers kThreads x kRows a-rows of one batch item and one range of
//    b-rows. Where B x ceil(N / (kThreads x kRows)) blocks would leave the
//    SMs few warps each, the plan splits b's rows over several blocks, each
//    split writes its minima to a [splits, B, N] scratch, and a second
//    kernel reduces them with the same NaN-propagating min, in a fixed order.
//    The grid is 1-D over (batch, split, a-tile), so B has no 65535 limit.
//  * Asynchronous staging (the old kernel loaded each chunk of b with scalar
//    loads, then waited, then computed). b goes to shared memory by
//    cp.async, kChunk rows at a time through two buffers: the copy of the
//    next chunk runs while the block computes on this one, and the first
//    copy runs while the block loads its a-rows. A chunk whose row count is
//    not a multiple of 4 is padded with copies of its last row, which change
//    no minimum.
//  * D is a runtime argument. D = 3 takes the tiled path; any other
//    D <= kMaxD takes a plain one (one a-row a thread, b staged with plain
//    loads, never split), which no caller on the port's paths uses.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 8;        // a-rows a thread owns (D = 3)
constexpr int kChunk = 256;     // b-rows a stage buffer holds; a multiple of 4
constexpr int kMaxD = 8;
constexpr int kCombineThreads = 256;

__device__ __forceinline__ float min_nan(float x, float y) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(y));
  return r;
}

__device__ __forceinline__ float dist2(float ax, float ay, float az, float bx,
                                       float by, float bz) {
  const float dx = __fsub_rn(ax, bx), dy = __fsub_rn(ay, by),
              dz = __fsub_rn(az, bz);
  return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
}

// Copies b-rows [0, n) of `src` (12 B a row) into `dst` as one cp.async
// group, padded to a multiple of 4 rows with copies of row n - 1.
__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  const int elems = ((n + 3) & ~3) * 3;
  for (int e = threadIdx.x; e < elems; e += kThreads) {
    const int row = e / 3;
    const int from = row < n ? e : (n - 1) * 3 + (e - row * 3);
    const unsigned to =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + e));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(to), "l"(src + from) : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Block (batch, split, tile) of the plan: a-rows tile*kThreads*R + r*kThreads
// + threadIdx.x for r < R, b-rows [split*split_rows, +split_rows) clipped to
// M. Writes dst[(split*B + batch)*N + row]: the output when splits == 1,
// the scratch otherwise.
template <int R>
__global__ void __launch_bounds__(kThreads)
min_dist2_d3(const float* __restrict__ a, const float* __restrict__ b,
             float* __restrict__ dst, int B, int N, int M, int tiles,
             int splits, int split_rows) {
  __shared__ __align__(16) float sb[2][kChunk * 3];
  const int tile = blockIdx.x % tiles;
  const int split = (blockIdx.x / tiles) % splits;
  const int batch = blockIdx.x / tiles / splits;
  const int lo = split * split_rows;
  const int rows = min(M - lo, split_rows);
  const int chunks = (rows + kChunk - 1) / kChunk;
  const float* bb = b + ((size_t)batch * M + lo) * 3;
  stage(sb[0], bb, min(kChunk, rows));

  const float* ab = a + (size_t)batch * N * 3;
  const int row0 = tile * kThreads * R + threadIdx.x;
  float ax[R], ay[R], az[R], best[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r * kThreads;
    const bool in = row < N;
    ax[r] = in ? ab[(size_t)row * 3 + 0] : 0.f;
    ay[r] = in ? ab[(size_t)row * 3 + 1] : 0.f;
    az[r] = in ? ab[(size_t)row * 3 + 2] : 0.f;
    best[r] = CUDART_INF_F;
  }

  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      stage(sb[(c + 1) & 1], bb + (size_t)(c + 1) * kChunk * 3,
            min(kChunk, rows - (c + 1) * kChunk));
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // chunk c is in shared memory, for every thread
    const float4* q = reinterpret_cast<const float4*>(sb[c & 1]);
    const int quads = (min(kChunk, rows - c * kChunk) + 3) >> 2;
#pragma unroll 4
    for (int j = 0; j < quads; ++j) {
      const float4 p = q[3 * j], s = q[3 * j + 1], t = q[3 * j + 2];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float d0 = dist2(ax[r], ay[r], az[r], p.x, p.y, p.z);
        const float d1 = dist2(ax[r], ay[r], az[r], p.w, s.x, s.y);
        const float d2 = dist2(ax[r], ay[r], az[r], s.z, s.w, t.x);
        const float d3 = dist2(ax[r], ay[r], az[r], t.y, t.z, t.w);
        best[r] = min_nan(best[r], min_nan(min_nan(d0, d1), min_nan(d2, d3)));
      }
    }
    __syncthreads();  // chunk c's buffer is free for the copy of chunk c + 2
  }

  float* o = dst + ((size_t)split * B + batch) * N;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r * kThreads;
    if (row < N) o[row] = best[r];
  }
}

// out[i] = min over the splits of part[k][i], NaN-propagating, k in order.
__global__ void __launch_bounds__(kCombineThreads)
min_dist2_combine(const float* __restrict__ part, float* __restrict__ out,
                  size_t total, int splits) {
  const size_t i = (size_t)blockIdx.x * kCombineThreads + threadIdx.x;
  if (i >= total) return;
  float v = part[i];
  for (int k = 1; k < splits; ++k) v = min_nan(v, part[(size_t)k * total + i]);
  out[i] = v;
}

__global__ void __launch_bounds__(kThreads)
min_dist2_generic(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ out, int N, int M, int D, int tiles) {
  __shared__ float sb[kChunk * kMaxD];
  const int tile = blockIdx.x % tiles;
  const int batch = blockIdx.x / tiles;
  const int row = tile * kThreads + threadIdx.x;
  const float* ab = a + (size_t)batch * N * D;
  const float* bb = b + (size_t)batch * M * D;
  float av[kMaxD];
#pragma unroll
  for (int d = 0; d < kMaxD; ++d)
    av[d] = (row < N && d < D) ? ab[(size_t)row * D + d] : 0.f;
  float best = CUDART_INF_F;
  for (int base = 0; base < M; base += kChunk) {
    const int rows = min(kChunk, M - base);
    __syncthreads();  // the previous chunk is no longer read
    for (int i = threadIdx.x; i < rows * D; i += kThreads)
      sb[i] = bb[(size_t)base * D + i];
    __syncthreads();
    for (int j = 0; j < rows; ++j) {
      const float t0 = __fsub_rn(av[0], sb[j * D]);
      float s = __fmul_rn(t0, t0);
#pragma unroll
      for (int d = 1; d < kMaxD; ++d) {
        if (d < D) {
          const float t = __fsub_rn(av[d], sb[j * D + d]);
          s = __fmaf_rn(t, t, s);
        }
      }
      best = min_nan(best, s);
    }
  }
  if (row < N) out[(size_t)batch * N + row] = best;
}

// Launches the distance kernel and, when b is split, the combine kernel on
// `s`; cudaGetLastError() after each launch.
cudaError_t launch(const float* a, const float* b, float* out, float* scratch,
                   int B, int N, int M, int D, int tiles, unsigned blocks,
                   int splits, int split_rows, unsigned combine_blocks,
                   cudaStream_t s) {
  if (D != 3) {
    min_dist2_generic<<<blocks, kThreads, 0, s>>>(a, b, out, N, M, D, tiles);
    return cudaGetLastError();
  }
  min_dist2_d3<kRows><<<blocks, kThreads, 0, s>>>(
      a, b, splits > 1 ? scratch : out, B, N, M, tiles, splits, split_rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  min_dist2_combine<<<combine_blocks, kCombineThreads, 0, s>>>(
      scratch, out, (size_t)B * N, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int min_dist2_max_d() { return kMaxD; }

// Launches the plan on `stream` of CUDA device `device` (made current for
// the launches, the caller's device restored after). Returns a cudaError_t
// as an int (0 = ok), or cudaErrorInvalidValue for a plan this file does
// not implement.
int min_dist2_launch(const float* a, const float* b, float* out,
                     float* scratch, int B, int N, int M, int D,
                     int rows_per_thread, int threads, int splits,
                     int split_rows, int device, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const bool tiled = D == 3;
  if (M <= 0 || D <= 0 || D > kMaxD || threads != kThreads || splits < 1 ||
      split_rows < 1 || rows_per_thread != (tiled ? kRows : 1) ||
      (!tiled && splits != 1) || (splits > 1 && scratch == nullptr) ||
      (long long)(splits - 1) * split_rows >= M ||
      (long long)splits * split_rows < M)
    return (int)cudaErrorInvalidValue;
  const long long per_block = (long long)threads * rows_per_thread;
  const long long tiles = (N + per_block - 1) / per_block;
  const long long blocks = (long long)B * tiles * splits;
  const size_t combine_blocks =
      ((size_t)B * N + kCombineThreads - 1) / kCombineThreads;
  if (blocks > INT_MAX || (splits > 1 && combine_blocks > INT_MAX))
    return (int)cudaErrorInvalidValue;
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = launch(a, b, out, scratch, B, N, M, D, (int)tiles,
                 (unsigned)blocks, splits, split_rows,
                 (unsigned)combine_blocks, static_cast<cudaStream_t>(stream));
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

const char* min_dist2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
