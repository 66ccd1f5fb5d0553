// ransac_kabsch: the net-initialised RANSAC-Kabsch refinement's robust fit,
// one thread-block cluster a ROI, one launch a batch. model [B,N,3], cam
// [B,N,3], mask [B,N] (1 = valid), uniforms [B,H,S] float32 -> R [B,3,3],
// t [B,3], ratio [B], best [B,2] int64 (the best hypothesis, its inliers).
//
// Replaces rdpn6d_tpu/ops/ransac_kabsch.py:125 ransac_kabsch (vmapped over
// the ROIs by refine_pose_kabsch, :199), XLA code and not a Pallas kernel:
// an inverse-CDF sample over the mask (cumsum + searchsorted, :139-144),
// Horn's quaternion fits (kabsch_quat, :62), the [H,9]@[9,N] scoring on
// the MXU (:152-165), an argmax and a weighted SVD refit (kabsch, :33).
// Its plain version is ops/ransac_kabsch.ransac_kabsch_plain.
//
// A ROI's work is split over a cluster of C blocks (C a power of two up to
// 16). The wrapper takes the largest C with which the card holds every
// ROI's cluster at once at one block an SM (ransac_kabsch_cluster_slots:
// on an H100 SXM 16 blocks at B <= 7, 4 at B = 16, 2 at B = 32, 1 at B >
// 66). Its points are cut into tiles of kTile; rank r of the cluster owns
// the contiguous tiles [ceil(r T / C), ceil((r + 1) T / C)) and stages
// their points (xyz and mask, xyz and cdf: two float4s a point) in its
// shared memory. The blocks trade counts, fits and partial sums through
// distributed shared memory, with a cluster barrier after each exchange.
//
// Stages:
//  1. Scan. Each block takes its points' inclusive float32 prefix sum of
//     the mask (exact for a 0/1 mask up to 2^24 points) and publishes its
//     total; after the barrier every block reads the ranks' totals and
//     adds the lower ranks' to its own cdf, which then holds the global
//     values the parent's [B,N] scratch held.
//  2. Sample. Pick s of hypothesis h is the left insertion point of u *
//     max(total, 1) into the cdf, clipped to N-1 (an all-zero mask picks
//     as searchsorted does). The block whose slice holds it (the first
//     rank whose inclusive total is not below u) finds it by a binary
//     search of its own cdf and writes the pair to the block that fits h.
//  3. Fit. The hypotheses are spread over the cluster, about H / C a
//     block, a half warp each (a lane an entry of the 4x4 matrix, with
//     the operations of one thread doing the whole fit, in its order, so
//     the same bits): Horn's 4x4 K of the S picks (weights 1, eps 1e-9),
//     shifted by its Frobenius norm, 14 normalised squarings, the column
//     of largest norm (the first of equal ones) as the quaternion, as
//     kabsch_quat does. Each block sends its fits to every block.
//  4. Score. Each block counts, for every hypothesis, its own points with
//     d2 < thr^2 where the mask is > 0 (the spent cdf slot of a point
//     holds thr^2 there and -1 elsewhere, one compare a pair): a lane
//     holds two hypotheses' R and t in registers and their counts, a warp
//     walks a share of the block's points kPts at a time, each point two
//     16-byte broadcast reads of shared memory; a lane's counts go to the
//     block's integer counts by shared atomic adds. d2 is the direct form
//     |R m + t - c|^2 with every op _rn, so the refit's recount gives the
//     same bits and the counts are the first design's; the plain
//     version keeps the JAX package's expanded form, so a d2 within
//     rounding of thr^2 may count on one side only. A NaN point is no
//     inlier. Every block sends its counts to every block, which sums them
//     in integers and takes the best hypothesis: the lowest index of the
//     highest score, as jnp.argmax.
//  5. Refit. Weights are the best hypothesis's inliers, or the mask where
//     it has fewer than S. Each tile's sums of w, w m and w c, then of
//     (m - cm) w (c - cc)^T, are taken by a fixed tree (a thread a point,
//     warps by shuffles, then the tile's 8 warps in order) and summed over
//     the tiles in tile order: no float atomics, so a ROI's outputs do not
//     depend on C, on B or on the other ROIs. Every point is multiplied by
//     its weight even at 0, so a NaN point makes the sums NaN as in the
//     JAX package. One thread of the lead block takes the SVD of the
//     covariance by one-sided Jacobi in float64, sorts the singular
//     values, completes U where the covariance is rank deficient (a zero
//     covariance gives U = V = I, as LAPACK does), and forms R = V diag(1,
//     1, det(V U^T)) U^T, t = cc - R cm and ratio = score / max(sum(mask),
//     1). A non-finite covariance gives NaN R and t.
//
// Bound: operations. Scoring is H x N pairs a ROI at ~20 FP32 operations
// (9 multiply-adds of R m + t - c, 3 for the squares, the compare), 10.5
// MFLOP a ROI at H = 128, N = 4096; each input is read once, N x 7 x 4 B a
// ROI (115 KB). At B = 16: 168 MFLOP at 67 TFLOP/s, 2.5 us, against 1.8 MB
// at 3.35 TB/s, 0.55 us. One block a ROI would leave most SMs idle (16 of
// 132 at B = 16); the cluster spreads the scoring over B x C SMs. What
// stays serial a ROI is a fit's latency on a half warp (14 squarings of
// a 4x4 matrix, each a chain of shuffles, a 16-term norm, a square root
// and an IEEE division, kept for the first design's bits), the six
// cluster barriers and the float64 SVD on one thread. The [H,9]@[9,N]
// product on tensor cores is untried: TF32 would move counts near thr^2.
// The fit and the SVD index their local arrays by constants only (selects
// where the order is found at run time), so they stay in registers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cmath>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 256;       // points a refit partial sum covers
constexpr int kTilesAtOnce = kThreads / kTile;
constexpr int kPts = 4;          // points a scoring step reads at once
constexpr int kHornIters = 14;
constexpr int kMaxSample = 16;   // S a fit holds in local arrays
constexpr int kMaxCluster = 16;  // blocks a ROI at most
constexpr int kSweeps = 24;      // one-sided Jacobi sweeps at most
constexpr int kMaxSmem = 232448; // a block's shared memory on sm_90
constexpr int kMaxDevices = 64;  // devices whose attributes are kept set
constexpr float kEps = 1e-9f;
constexpr unsigned kFull = 0xffffffffu;

// Dynamic shared memory of a block: its points (xyz, mask, xyz, cdf), every
// hypothesis's R and t, the ranks' counts and its own, the picks of its
// hypotheses, and the tiles' partial sums (7 and 9 a tile)
__host__ __device__ inline size_t smem_bytes(int N, int H, int S, int C) {
  const int tiles = (N + kTile - 1) / kTile;
  const int pmax = (tiles + C - 1) / C * kTile;
  const int nh = (H + C - 1) / C;
  return (size_t)4 * ((size_t)8 * pmax + (size_t)12 * H + (size_t)(C + 1) * H +
                      (size_t)6 * nh * S + (size_t)16 * tiles);
}

// the first of rank r's n / C-th share of n items (tiles or hypotheses):
// ceil(r n / C), so item i belongs to rank i C / n
__device__ __forceinline__ int share_start(int r, int n, int C) {
  return (r * n + C - 1) / C;
}

// |R m + t - c|^2, every op rounded on its own: the same bits wherever it
// is inlined
__device__ __forceinline__ float dist2(const float* r, float mx, float my,
                                       float mz, float cx, float cy,
                                       float cz) {
  const float ex = __fsub_rn(
      __fmaf_rn(r[0], mx, __fmaf_rn(r[1], my, __fmaf_rn(r[2], mz, r[9]))),
      cx);
  const float ey = __fsub_rn(
      __fmaf_rn(r[3], mx, __fmaf_rn(r[4], my, __fmaf_rn(r[5], mz, r[10]))),
      cy);
  const float ez = __fsub_rn(
      __fmaf_rn(r[6], mx, __fmaf_rn(r[7], my, __fmaf_rn(r[8], mz, r[11]))),
      cz);
  return __fmaf_rn(ez, ez, __fmaf_rn(ey, ey, __fmul_rn(ex, ex)));
}

// hypothesis h's R and t from hyp [H][12] into r, by three 16-byte reads
__device__ __forceinline__ void load_hyp(const float* hyp, int h, float* r) {
  const float4* q = reinterpret_cast<const float4*>(hyp + 12 * h);
  const float4 q0 = q[0], q1 = q[1], q2 = q[2];
  r[0] = q0.x, r[1] = q0.y, r[2] = q0.z, r[3] = q0.w;
  r[4] = q1.x, r[5] = q1.y, r[6] = q1.z, r[7] = q1.w;
  r[8] = q2.x, r[9] = q2.y, r[10] = q2.z, r[11] = q2.w;
}

// Horn's quaternion fit of S correspondences (weights 1), as kabsch_quat,
// by the 16 lanes of a half warp, lane e holding entry e of the 4x4
// matrix through the squarings (each lane forms its entry of the product
// and the norm from its neighbours' by shuffles, in the order and with the
// operations of one thread doing all 16). pk[6 s ..] = (src, dst) of pick
// s; where `store`, lane 0 of the half writes r[0..8] = R row-major,
// r[9..11] = t. Every lane of the warp calls it. Every local array is
// indexed by constants, so it stays in registers
__device__ void horn_fit(const float* pk, int S, float* r, bool store) {
  const int e = threadIdx.x & 15, ei = e >> 2, ej = e & 3;
  float cs[3] = {0.f, 0.f, 0.f}, cd[3] = {0.f, 0.f, 0.f};
  float wsum = 0.f;
  for (int s = 0; s < S; ++s) {
    wsum += 1.f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      cs[d] += pk[6 * s + d];
      cd[d] += pk[6 * s + 3 + d];
    }
  }
  wsum += kEps;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    cs[d] = cs[d] / wsum;
    cd[d] = cd[d] / wsum;
  }
  float h[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < S; ++s) {
    float a[3], b[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      a[d] = pk[6 * s + d] - cs[d];
      b[d] = pk[6 * s + 3 + d] - cd[d];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) h[3 * i + j] += a[i] * b[j];
  }
  const float Sxx = h[0], Sxy = h[1], Sxz = h[2], Syx = h[3], Syy = h[4],
              Syz = h[5], Szx = h[6], Szy = h[7], Szz = h[8];
  float m[16] = {Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx,
                 Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz,
                 Szx - Sxz, Sxy + Syx, Syy - Sxx - Szz, Syz + Szy,
                 Sxy - Syx, Szx + Sxz, Syz + Szy, Szz - Sxx - Syy};
  float fro = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) fro += m[i] * m[i];
  fro = sqrtf(fro) + kEps;
  float me = 0.f;  // this lane's entry
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i == e) me = m[i] / fro + ((i % 5 == 0) ? 1.f : 0.f);
  for (int it = 0; it < kHornIters; ++it) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      acc += __shfl_sync(kFull, me, 4 * ei + k, 16) *
             __shfl_sync(kFull, me, 4 * k + ej, 16);
    float n2 = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float pi = __shfl_sync(kFull, acc, i, 16);
      n2 += pi * pi;
    }
    const float n = sqrtf(n2) + kEps;
    me = acc / n;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) m[i] = __shfl_sync(kFull, me, i, 16);
  int jb = 0;
  float best = -1.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float c = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) c += m[4 * i + j] * m[4 * i + j];
    c = sqrtf(c);
    if (j == 0 || c > best) {  // the first of equal norms
      best = c;
      jb = j;
    }
  }
  float q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    q[i] = jb == 0 ? m[4 * i] : jb == 1 ? m[4 * i + 1]
                              : jb == 2 ? m[4 * i + 2] : m[4 * i + 3];
  const float qn =
      sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]) + kEps;
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = q[i] / qn;
  const float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
  float rr[12];
  rr[0] = 1.f - 2.f * (qy * qy + qz * qz);
  rr[1] = 2.f * (qx * qy - qw * qz);
  rr[2] = 2.f * (qx * qz + qw * qy);
  rr[3] = 2.f * (qx * qy + qw * qz);
  rr[4] = 1.f - 2.f * (qx * qx + qz * qz);
  rr[5] = 2.f * (qy * qz - qw * qx);
  rr[6] = 2.f * (qx * qz - qw * qy);
  rr[7] = 2.f * (qy * qz + qw * qx);
  rr[8] = 1.f - 2.f * (qx * qx + qy * qy);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    rr[9 + i] = cd[i] - (rr[3 * i] * cs[0] + rr[3 * i + 1] * cs[1] +
                         rr[3 * i + 2] * cs[2]);
  if (store && e == 0)
#pragma unroll
    for (int i = 0; i < 12; ++i) r[i] = rr[i];
}

__device__ inline double det3(const double (&a)[3][3]) {
  return a[0][0] * (a[1][1] * a[2][2] - a[1][2] * a[2][1]) -
         a[0][1] * (a[1][0] * a[2][2] - a[1][2] * a[2][0]) +
         a[0][2] * (a[1][0] * a[2][1] - a[1][1] * a[2][0]);
}

__device__ inline void cross3(const double* a, const double* b, double* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ inline void unit3(double* a) {
  const double n = sqrt(a[0] * a[0] + a[1] * a[1] + a[2] * a[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) a[i] /= n;
}

// v[k] by selects: an array read at a run-time index would live in local
// memory
__device__ __forceinline__ double pick3(const double (&v)[3], int k) {
  return k == 0 ? v[0] : (k == 1 ? v[1] : v[2]);
}

// R = V diag(1, 1, det(V U^T)) U^T of the SVD H = U S V^T, by one-sided
// Jacobi on H's columns in float64
__device__ void svd_rotation(const float* hf, float* R) {
  bool finite = true;
  for (int i = 0; i < 9; ++i) finite = finite && isfinite(hf[i]);
  if (!finite) {
    for (int i = 0; i < 9; ++i) R[i] = __int_as_float(0x7fc00000);
    return;
  }
  double A[3][3], V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      A[i][j] = hf[3 * i + j];
      V[i][j] = i == j ? 1.0 : 0.0;
    }
  const int P[3] = {0, 0, 1}, Q[3] = {1, 2, 2};
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    bool rotated = false;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int p = P[k], q = Q[k];
      double alpha = 0.0, beta = 0.0, gamma = 0.0;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        alpha += A[i][p] * A[i][p];
        beta += A[i][q] * A[i][q];
        gamma += A[i][p] * A[i][q];
      }
      if (fabs(gamma) <= 1e-15 * sqrt(alpha * beta)) continue;
      rotated = true;
      const double zeta = (beta - alpha) / (2.0 * gamma);
      const double tt =
          copysign(1.0, zeta) / (fabs(zeta) + sqrt(1.0 + zeta * zeta));
      const double c = 1.0 / sqrt(1.0 + tt * tt), s = c * tt;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const double ap = A[i][p], aq = A[i][q];
        A[i][p] = c * ap - s * aq;
        A[i][q] = s * ap + c * aq;
        const double vp = V[i][p], vq = V[i][q];
        V[i][p] = c * vp - s * vq;
        V[i][q] = s * vp + c * vq;
      }
    }
    if (!rotated) break;
  }
  // singular values (column norms), descending; a stable order. The
  // order is applied by selects (pick3), so A, V and sig stay in registers
  double sig[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    sig[j] = sqrt(A[0][j] * A[0][j] + A[1][j] * A[1][j] + A[2][j] * A[2][j]);
  int ord[3] = {0, 1, 2};
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2 - a; ++b)
      if (pick3(sig, ord[b + 1]) > pick3(sig, ord[b])) {
        const int tmp = ord[b];
        ord[b] = ord[b + 1];
        ord[b + 1] = tmp;
      }
  const double s0 = pick3(sig, ord[0]), s1 = pick3(sig, ord[1]),
               s2 = pick3(sig, ord[2]);
  double U[3][3], Vs[3][3];  // columns in descending order
  double u[3][3];            // u[k] = column k of U
  const double tol = s0 * 1e-12;
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < 3; ++i) Vs[i][k] = pick3(V[i], ord[k]);
  if (!(s0 > 0.0)) {
    // a zero covariance: U = V = I
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k) Vs[i][k] = U[i][k] = i == k ? 1.0 : 0.0;
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i) u[0][i] = pick3(A[i], ord[0]) / s0;
    if (s1 > tol) {
#pragma unroll
      for (int i = 0; i < 3; ++i) u[1][i] = pick3(A[i], ord[1]) / s1;
    } else {
      // any unit vector orthogonal to u0: the axis it leans on least
      int e = 0;
#pragma unroll
      for (int i = 1; i < 3; ++i)
        if (fabs(u[0][i]) < fabs(pick3(u[0], e))) e = i;
      const double ue = pick3(u[0], e);
#pragma unroll
      for (int i = 0; i < 3; ++i)
        u[1][i] = (i == e ? 1.0 : 0.0) - ue * u[0][i];
      unit3(u[1]);
    }
    if (s2 > tol) {
#pragma unroll
      for (int i = 0; i < 3; ++i) u[2][i] = pick3(A[i], ord[2]) / s2;
    } else {
      cross3(u[0], u[1], u[2]);
      unit3(u[2]);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k) U[i][k] = u[k][i];
  }
  const double d = det3(Vs) * det3(U);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      R[3 * i + j] = (float)(Vs[i][0] * U[j][0] + Vs[i][1] * U[j][1] +
                             d * Vs[i][2] * U[j][2]);
}

// The K sums of the kTilesAtOnce tiles [t, t + kTilesAtOnce) of this
// block, a thread a point (v its point's terms, 0 past N): a warp's by
// shuffles, then each tile's 8 warps in order by one thread, which writes
// the tile's K sums to tab[tile][K] of the ranks [q0, q1). red holds
// kWarps * K floats. Every thread of the block calls it.
template <int K>
__device__ void tile_sums(float (&v)[K], int t, int t_end, float* red,
                          float* tab, cg::cluster_group& cluster, int q0,
                          int q1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_xor_sync(kFull, v[k], o);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp * K + k] = v[k];
  __syncthreads();
  constexpr int kTileWarps = kTile / 32;
  if (threadIdx.x < kTilesAtOnce * K) {
    const int half = threadIdx.x / K, k = threadIdx.x - half * K;
    const int tile = t + half;
    if (tile < t_end) {
      float s = 0.f;
      for (int w = 0; w < kTileWarps; ++w)
        s += red[(half * kTileWarps + w) * K + k];
      for (int q = q0; q < q1; ++q)
        cluster.map_shared_rank(tab, q)[tile * K + k] = s;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
    ransac_kabsch_kernel(const float* __restrict__ model,
                         const float* __restrict__ cam,
                         const float* __restrict__ mask,
                         const float* __restrict__ uniforms,
                         float* __restrict__ R_out,
                         float* __restrict__ t_out,
                         float* __restrict__ ratio_out,
                         long long* __restrict__ best_out, int N, int H,
                         int S, float thr2) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = (N + kTile - 1) / kTile;
  const int pmax = (tiles + C - 1) / C * kTile;
  const int nhmax = (H + C - 1) / C;
  // this block's tiles, points [p0, p0 + np) and hypotheses [h0, h1)
  const int t0 = share_start(rank, tiles, C);
  const int t1 = share_start(rank + 1, tiles, C);
  const int p0 = t0 * kTile;
  const int np = max(0, min(t1 * kTile, N) - p0);
  const int h0 = share_start(rank, H, C), h1 = share_start(rank + 1, H, C);

  extern __shared__ float4 dyn[];
  // point i: pts[2 i] = (m, mask), pts[2 i + 1] = (c, the global cdf; from
  // stage 3 on, the point's inlier threshold)
  float4* pts = dyn;
  float* hyp = reinterpret_cast<float*>(pts + 2 * pmax);  // [H][12]: R, t
  int* part = reinterpret_cast<int*>(hyp + 12 * H);  // [C][H] the ranks'
  int* score = part + C * H;                     // [H] this block's counts
  float* picks = reinterpret_cast<float*>(score + H);  // [nhmax][S][6]
  float* tab7 = picks + 6 * nhmax * S;           // [tiles][7]
  float* tab9 = tab7 + 7 * tiles;                // [tiles][9], the lead's
  __shared__ float red[kWarps * 9];
  __shared__ float incl[kMaxCluster];  // the ranks' inclusive totals
  __shared__ float tot_s;              // this block's sum(mask)
  __shared__ float sums[9];
  __shared__ int best_s[2];

  // the first uniform this thread reads, loaded now: its latency hides
  // behind the staging and the scan
  const float* ub = uniforms + (size_t)b * H * S;
  float u_next = tid < H * S ? ub[tid] : 0.f;
  const float* mb = model + (size_t)b * N * 3 + (size_t)p0 * 3;
  const float* cb = cam + (size_t)b * N * 3 + (size_t)p0 * 3;
  const float* kb = mask + (size_t)b * N + p0;
  for (int i = tid; i < np; i += kThreads) {
    pts[2 * i] = make_float4(mb[3 * i], mb[3 * i + 1], mb[3 * i + 2], kb[i]);
    pts[2 * i + 1] = make_float4(cb[3 * i], cb[3 * i + 1], cb[3 * i + 2], 0.f);
  }
  for (int h = tid; h < H; h += kThreads) score[h] = 0;
  __syncthreads();

  // 1. the mask's inclusive prefix sum ---------------------------------
  float carry = 0.f;
  for (int base = 0; base < np; base += kThreads) {
    const int i = base + tid;
    float x = i < np ? pts[2 * i].w : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) red[warp] = x;
    __syncthreads();
    if (warp == 0) {
      float w = lane < kWarps ? red[lane] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w += y;
      }
      if (lane < kWarps) red[kWarps + lane] = w;
    }
    __syncthreads();
    if (i < np)
      pts[2 * i + 1].w = carry + (warp > 0 ? red[kWarps + warp - 1] : 0.f) + x;
    carry += red[2 * kWarps - 1];
    __syncthreads();
  }
  if (tid == 0) tot_s = carry;
  cluster.sync();  // every block's total published
  if (tid < C) incl[tid] = *cluster.map_shared_rank(&tot_s, tid);
  __syncthreads();
  if (tid == 0)
    for (int r = 1; r < C; ++r) incl[r] += incl[r - 1];
  __syncthreads();
  const float total = incl[C - 1];  // sum(mask)
  if (rank > 0)
    for (int i = tid; i < np; i += kThreads) pts[2 * i + 1].w += incl[rank - 1];
  __syncthreads();

  // 2. sample: each pick by the block whose slice holds it --------------
  const float scale = fmaxf(total, 1.f);
  for (int p = tid; p < H * S; p += kThreads) {
    const float u = u_next * scale;
    if (p + kThreads < H * S) u_next = ub[p + kThreads];
    int owner = 0;  // the first rank whose inclusive total is not below u
    while (owner < C && incl[owner] < u) ++owner;
    const bool past = owner == C;  // past every cdf value: N - 1, clipped
    if (past) owner = (N - 1) / kTile * C / tiles;
    if (owner != rank) continue;
    int idx = N - 1;
    if (!past) {
      int lo = 0, hi = np;  // the first i with cdf[i] >= u
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (pts[2 * mid + 1].w < u)
          lo = mid + 1;
        else
          hi = mid;
      }
      idx = p0 + (lo < np ? lo : np - 1);
    }
    const int h = p / S, s = p - h * S;
    const int f = h * C / H;  // the rank that fits h
    float* dst = cluster.map_shared_rank(picks, f) +
                 ((h - share_start(f, H, C)) * S + s) * 6;
    const float4 m = pts[2 * (idx - p0)], c = pts[2 * (idx - p0) + 1];
    dst[0] = m.x;
    dst[1] = m.y;
    dst[2] = m.z;
    dst[3] = c.x;
    dst[4] = c.y;
    dst[5] = c.z;
  }
  cluster.sync();  // every pick delivered

  // 3. fit this block's hypotheses, a half warp each, and share them -----
  // the cdf is spent: each point's slot takes its own inlier threshold,
  // thr^2 where the mask is > 0 and -1 (below every d2) where it is not
  for (int i = tid; i < np; i += kThreads)
    pts[2 * i + 1].w = pts[2 * i].w > 0.f ? thr2 : -1.f;
  for (int base = h0 + 2 * warp; base < h1; base += 2 * kWarps) {
    const int h = base + (lane >> 4);
    const int hc = h < h1 ? h : base;  // the second half's, past h1: idle
    horn_fit(picks + (hc - h0) * S * 6, S, hyp + 12 * hc, h < h1);
  }
  __syncthreads();
  const int nf = 12 * (h1 - h0);
  for (int i = tid; i < nf * C; i += kThreads) {
    const int q = i / nf, j = 12 * h0 + i - q * nf;
    if (q != rank) cluster.map_shared_rank(hyp, q)[j] = hyp[j];
  }
  cluster.sync();  // every block holds every fit

  // 4. score: a lane two hypotheses, a warp 64 of them over a share of
  // this block's points, each point a broadcast read ---------------------
  const int hgroups = (H + 63) / 64;
  const int psplit = hgroups >= kWarps ? 1 : kWarps / hgroups;
  for (int item = warp; item < hgroups * psplit; item += kWarps) {
    const int hg = item / psplit, ps = item - hg * psplit;
    const int ha = hg * 64 + lane, hb = ha + 32;
    float ra[12], rb[12];
    load_hyp(hyp, min(ha, H - 1), ra);
    load_hyp(hyp, min(hb, H - 1), rb);
    const int ja = ps * np / psplit, jb = (ps + 1) * np / psplit;
    unsigned ca = 0, cb = 0;
    int j = ja;
    for (; j + kPts <= jb; j += kPts) {
#pragma unroll
      for (int k = 0; k < kPts; ++k) {
        const float4 m = pts[2 * (j + k)], c = pts[2 * (j + k) + 1];
        ca += dist2(ra, m.x, m.y, m.z, c.x, c.y, c.z) < c.w;
        cb += dist2(rb, m.x, m.y, m.z, c.x, c.y, c.z) < c.w;
      }
    }
    for (; j < jb; ++j) {
      const float4 m = pts[2 * j], c = pts[2 * j + 1];
      ca += dist2(ra, m.x, m.y, m.z, c.x, c.y, c.z) < c.w;
      cb += dist2(rb, m.x, m.y, m.z, c.x, c.y, c.z) < c.w;
    }
    if (ha < H) atomicAdd(&score[ha], (int)ca);
    if (hb < H) atomicAdd(&score[hb], (int)cb);
  }
  __syncthreads();
  for (int i = tid; i < C * H; i += kThreads) {
    const int q = i / H, h = i - q * H;
    cluster.map_shared_rank(part, q)[rank * H + h] = score[h];
  }
  cluster.sync();  // every block holds every rank's counts
  if (warp == 0) {
    int bh = H, bs = INT_MIN;  // the lane's best of h = lane + 32 k
    for (int h = lane; h < H; h += 32) {
      int s = 0;
      for (int q = 0; q < C; ++q) s += part[q * H + h];
      if (s > bs) {
        bs = s;
        bh = h;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const int os = __shfl_xor_sync(kFull, bs, o);
      const int oh = __shfl_xor_sync(kFull, bh, o);
      if (os > bs || (os == bs && oh < bh)) {
        bs = os;
        bh = oh;
      }
    }
    if (lane == 0) {
      best_s[0] = bh;
      best_s[1] = bs;
    }
  }
  __syncthreads();
  const int bh = best_s[0], bs = best_s[1];
  const bool use_inl = bs >= S;
  float r[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) r[i] = hyp[12 * bh + i];

  // 5. the weighted refit, by tiles in tile order ------------------------
  // the point of this thread in the pass at tile t, its weight
  const int half = tid / kTile, lane_t = tid - half * kTile;
  auto point = [&](int t, float4& m, float4& c) -> float {
    const int i = (t + half) * kTile + lane_t - p0;  // in this block
    if (t + half >= t1 || i >= np) {
      m = c = make_float4(0.f, 0.f, 0.f, 0.f);
      return 0.f;
    }
    m = pts[2 * i];
    c = pts[2 * i + 1];
    return use_inl
               ? (dist2(r, m.x, m.y, m.z, c.x, c.y, c.z) < c.w ? 1.f : 0.f)
               : m.w;
  };
  for (int t = t0; t < t1; t += kTilesAtOnce) {
    float4 m, c;
    const float w = point(t, m, c);
    float v[7] = {w, m.x * w, m.y * w, m.z * w, c.x * w, c.y * w, c.z * w};
    tile_sums<7>(v, t, t1, red, tab7, cluster, 0, C);
  }
  cluster.sync();  // every block holds every tile's first sums
  if (tid < 7) {
    float s = 0.f;
    for (int t = 0; t < tiles; ++t) s += tab7[t * 7 + tid];
    sums[tid] = s;
  }
  __syncthreads();
  const float wsum = sums[0] + kEps;
  const float cm[3] = {sums[1] / wsum, sums[2] / wsum, sums[3] / wsum};
  const float cc[3] = {sums[4] / wsum, sums[5] / wsum, sums[6] / wsum};
  for (int t = t0; t < t1; t += kTilesAtOnce) {
    float4 m, c;
    const float w = point(t, m, c);
    const float a[3] = {(m.x - cm[0]) * w, (m.y - cm[1]) * w,
                        (m.z - cm[2]) * w};
    const float d[3] = {c.x - cc[0], c.y - cc[1], c.z - cc[2]};
    float v[9];
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int q = 0; q < 3; ++q) v[3 * p + q] = a[p] * d[q];
    tile_sums<9>(v, t, t1, red, tab9, cluster, 0, 1);
  }
  cluster.sync();  // the lead holds every tile's covariance sums
  if (rank != 0) return;
  if (tid < 9) {
    float s = 0.f;
    for (int t = 0; t < tiles; ++t) s += tab9[t * 9 + tid];
    sums[tid] = s;
  }
  __syncthreads();
  if (tid == 0) {
    float R[9];
    svd_rotation(sums, R);
#pragma unroll
    for (int i = 0; i < 9; ++i) R_out[(size_t)b * 9 + i] = R[i];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      t_out[(size_t)b * 3 + i] =
          cc[i] - (R[3 * i] * cm[0] + R[3 * i + 1] * cm[1] +
                   R[3 * i + 2] * cm[2]);
    ratio_out[b] = (float)bs / fmaxf(total, 1.f);
    best_out[2 * b] = bh;
    best_out[2 * b + 1] = bs;
  }
}

// Sets the kernel's attributes on `device`, the current device, once: the
// most dynamic shared memory the card lets a block ask for beside the
// kernel's static shared memory, and clusters past the portable 8 blocks.
cudaError_t prepare_kernel(int device) {
  static std::atomic<bool> ready[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (ready[device].load()) return cudaSuccess;
  cudaFuncAttributes fa;
  int optin = 0;
  cudaError_t err = cudaFuncGetAttributes(&fa, ransac_kabsch_kernel);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ransac_kabsch_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)fa.sharedSizeBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ransac_kabsch_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err == cudaSuccess) ready[device].store(true);
  return err;
}

}  // namespace

extern "C" {

// Launches one cluster of C blocks a ROI on `stream` of CUDA device
// `device` (made current for the launch, the caller's device restored
// after). Returns a cudaError_t as an int (0 = ok); cudaErrorInvalidValue
// for shapes this file does not take, and the launch's own error where
// the card cannot hold a cluster of C blocks with this shared memory.
int ransac_kabsch_launch(const float* model, const float* cam,
                         const float* mask, const float* uniforms, float* R,
                         float* t, float* ratio, long long* best, int B, int N,
                         int H, int S, int C, float thr2, int device,
                         void* stream) {
  if (B <= 0) return 0;
  if (N <= 0 || H <= 0 || S <= 0 || S > kMaxSample || C < 1 ||
      C > kMaxCluster || (C & (C - 1)) != 0 || (long long)N * 3 > INT_MAX ||
      (long long)B * C > INT_MAX || smem_bytes(N, H, S, C) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  const size_t smem = smem_bytes(N, H, S, C);
  if (err == cudaSuccess) err = prepare_kernel(device);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (err == cudaSuccess) {
    err = cudaLaunchKernelEx(&cfg, ransac_kabsch_kernel, model, cam, mask,
                             uniforms, R, t, ratio, best, N, H, S, thr2);
    if (err == cudaSuccess) err = cudaGetLastError();
  }
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

// Clusters of C blocks that CUDA device `device` holds at once when each
// block has an SM to itself (shared memory past half an SM's asks for
// that), or minus a cudaError_t: the wrapper's choice of C.
int ransac_kabsch_cluster_slots(int C, int device) {
  if (C < 1 || C > kMaxCluster || (C & (C - 1)) != 0)
    return -(int)cudaErrorInvalidValue;
  int prev = device, per_sm = 0, slots = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  const int smem = per_sm / 2 + 1;
  if (err == cudaSuccess) err = prepare_kernel(device);
  if (err == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&slots, ransac_kabsch_kernel, &cfg);
  }
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return err == cudaSuccess ? slots : -(int)err;
}

const char* ransac_kabsch_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
