// ransac_kabsch: the net-initialised RANSAC-Kabsch refinement's robust fit,
// one block a ROI, one launch a batch. model [B,N,3], cam [B,N,3], mask
// [B,N] (1 = valid), uniforms [B,H,S] float32 -> R [B,3,3], t [B,3],
// ratio [B], best [B,2] int32 (the best hypothesis, its inliers). cdf
// [B,N] is scratch.
//
// Replaces rdpn6d_tpu/ops/ransac_kabsch.py:125 ransac_kabsch (vmapped over
// the ROIs by refine_pose_kabsch, :199), XLA code and not a Pallas kernel:
// an inverse-CDF sample over the mask (cumsum + searchsorted, :139-144),
// Horn's quaternion fits (kabsch_quat, :62), the [H,9]@[9,N] scoring on
// the MXU (:152-165), an argmax and a weighted SVD refit (kabsch, :33).
// Its plain version is ops/ransac_kabsch.ransac_kabsch_plain.
//
// Stages, in one block of kThreads threads:
//  1. Sample. The mask's inclusive prefix sum in float32 by a block scan
//     (exact for a 0/1 mask up to 2^24 points) into the cdf scratch, its
//     total kept. Hypothesis h's pick s is the left insertion point of
//     u * max(total, 1) into the cdf, clipped to [0, N-1]: an all-zero
//     mask picks as searchsorted does.
//  2. Fit. One thread a hypothesis: Horn's 4x4 K of the S picks (weights
//     1, eps 1e-9), shifted by its Frobenius norm, 14 normalised squarings,
//     the column of largest norm (the first of equal ones) as the
//     quaternion, as kabsch_quat does. R and t go to shared memory.
//  3. Score. The points pass through shared memory in chunks of kChunk
//     (xyz, xyz, mask: 28 B a point, 112 KB at kChunk = 4096). A thread
//     keeps kPts points in registers and walks every hypothesis (three
//     16-byte broadcast loads of R and t), counting d2 < thr^2 where the
//     mask is > 0; a warp's counts are summed by __reduce_add_sync and
//     added to the hypothesis's score in shared memory. d2 is the direct
//     form |R m + t - c|^2 with every op _rn, so the refit's recount gives
//     the same bits; the plain version keeps the JAX package's expanded
//     form, so a d2 within rounding of thr^2 may count on one side only. A
//     NaN point is no inlier. The best hypothesis is the lowest index of
//     the highest score, as jnp.argmax.
//  4. Refit. Weights are the best hypothesis's inliers, or the mask where
//     it has fewer than S. Block sums of w, w m and w c give the
//     centroids, then of (m - cm) w (c - cc)^T the 3x3 covariance, in
//     float32, every point multiplied by its weight even at 0, so a NaN
//     point makes them NaN as in the JAX package. One thread takes the
//     SVD of the covariance by one-sided Jacobi in float64, sorts the
//     singular values, completes U where the covariance is rank deficient
//     (a zero covariance gives U = V = I, as LAPACK does), and forms
//     R = V diag(1, 1, det(V U^T)) U^T, t = cc - R cm and ratio = score /
//     max(sum(mask), 1). A non-finite covariance gives NaN R and t.
//
// Bound: operations. Scoring is H x N pairs a ROI at ~20 FP32 operations
// (9 multiply-adds of R m + t - c, 3 for the squares, the compare), 10.5
// MFLOP a ROI at H = 128, N = 4096; each input is read once, N x 7 x 4 B a
// ROI (115 KB). At B = 16: 168 MFLOP at 67 TFLOP/s, 2.5 us, against 1.8 MB
// at 3.35 TB/s, 0.55 us. This first design leaves that far behind: a ROI's
// scoring runs on one SM (16 of the card's 132 busy at B = 16), held by its
// instruction rate at ~20 instructions a pair; splitting a ROI's points
// over blocks, and tensor cores for the [H,9]@[9,N] product, are later
// work.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 4096;     // points staged at once
constexpr int kPts = 4;          // points a thread holds in a scoring pass
constexpr int kHornIters = 14;
constexpr int kMaxSample = 16;   // S a fit holds in local arrays
constexpr int kSweeps = 24;      // one-sided Jacobi sweeps at most
constexpr int kMaxSmem = 232448; // a block's shared memory on sm_90
constexpr float kEps = 1e-9f;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline size_t smem_bytes(int N, int H) {
  const int chunk = N < kChunk ? N : kChunk;
  return (size_t)7 * chunk * 4 + (size_t)H * 16 * 4;
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

// sums v over the block; every thread gets the totals in v. red holds
// kWarps * K floats, out K
template <int K>
__device__ void block_sum(float (&v)[K], float* red, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_xor_sync(kFull, v[k], o);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp * K + k] = v[k];
  __syncthreads();
  if (threadIdx.x < K) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * K + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = out[k];
  __syncthreads();
}

// Horn's quaternion fit of S correspondences (weights 1), as kabsch_quat:
// r[0..8] = R row-major, r[9..11] = t
__device__ void horn_fit(const float* src, const float* dst, int S,
                         float* r) {
  float cs[3] = {0.f, 0.f, 0.f}, cd[3] = {0.f, 0.f, 0.f};
  float wsum = 0.f;
  for (int s = 0; s < S; ++s) {
    wsum += 1.f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      cs[d] += src[3 * s + d];
      cd[d] += dst[3 * s + d];
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
      a[d] = src[3 * s + d] - cs[d];
      b[d] = dst[3 * s + d] - cd[d];
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
#pragma unroll
  for (int i = 0; i < 16; ++i) m[i] = m[i] / fro + ((i % 5 == 0) ? 1.f : 0.f);
  for (int it = 0; it < kHornIters; ++it) {
    float p[16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) acc += m[4 * i + k] * m[4 * k + j];
        p[4 * i + j] = acc;
      }
    float n2 = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) n2 += p[i] * p[i];
    const float n = sqrtf(n2) + kEps;
#pragma unroll
    for (int i = 0; i < 16; ++i) m[i] = p[i] / n;
  }
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
  for (int i = 0; i < 4; ++i) q[i] = m[4 * i + jb];
  const float qn =
      sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]) + kEps;
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = q[i] / qn;
  const float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
  r[0] = 1.f - 2.f * (qy * qy + qz * qz);
  r[1] = 2.f * (qx * qy - qw * qz);
  r[2] = 2.f * (qx * qz + qw * qy);
  r[3] = 2.f * (qx * qy + qw * qz);
  r[4] = 1.f - 2.f * (qx * qx + qz * qz);
  r[5] = 2.f * (qy * qz - qw * qx);
  r[6] = 2.f * (qx * qz - qw * qy);
  r[7] = 2.f * (qy * qz + qw * qx);
  r[8] = 1.f - 2.f * (qx * qx + qy * qy);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    r[9 + i] = cd[i] - (r[3 * i] * cs[0] + r[3 * i + 1] * cs[1] +
                        r[3 * i + 2] * cs[2]);
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
  for (int i = 0; i < 3; ++i) a[i] /= n;
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
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      A[i][j] = hf[3 * i + j];
      V[i][j] = i == j ? 1.0 : 0.0;
    }
  const int P[3] = {0, 0, 1}, Q[3] = {1, 2, 2};
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    bool rotated = false;
    for (int k = 0; k < 3; ++k) {
      const int p = P[k], q = Q[k];
      double alpha = 0.0, beta = 0.0, gamma = 0.0;
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
  // singular values (column norms), descending; a stable order
  double sig[3];
  int ord[3] = {0, 1, 2};
  for (int j = 0; j < 3; ++j)
    sig[j] = sqrt(A[0][j] * A[0][j] + A[1][j] * A[1][j] + A[2][j] * A[2][j]);
  for (int a = 0; a < 2; ++a)
    for (int b = 0; b < 2 - a; ++b)
      if (sig[ord[b + 1]] > sig[ord[b]]) {
        const int tmp = ord[b];
        ord[b] = ord[b + 1];
        ord[b + 1] = tmp;
      }
  double U[3][3], Vs[3][3];  // columns in descending order
  double u[3][3];            // u[k] = column k of U
  const double tol = sig[ord[0]] * 1e-12;
  for (int k = 0; k < 3; ++k)
    for (int i = 0; i < 3; ++i) Vs[i][k] = V[i][ord[k]];
  if (!(sig[ord[0]] > 0.0)) {
    // a zero covariance: U = V = I
    for (int i = 0; i < 3; ++i)
      for (int k = 0; k < 3; ++k) Vs[i][k] = U[i][k] = i == k ? 1.0 : 0.0;
  } else {
    for (int i = 0; i < 3; ++i) u[0][i] = A[i][ord[0]] / sig[ord[0]];
    if (sig[ord[1]] > tol) {
      for (int i = 0; i < 3; ++i) u[1][i] = A[i][ord[1]] / sig[ord[1]];
    } else {
      // any unit vector orthogonal to u0: the axis it leans on least
      int e = 0;
      for (int i = 1; i < 3; ++i)
        if (fabs(u[0][i]) < fabs(u[0][e])) e = i;
      for (int i = 0; i < 3; ++i)
        u[1][i] = (i == e ? 1.0 : 0.0) - u[0][e] * u[0][i];
      unit3(u[1]);
    }
    if (sig[ord[2]] > tol) {
      for (int i = 0; i < 3; ++i) u[2][i] = A[i][ord[2]] / sig[ord[2]];
    } else {
      cross3(u[0], u[1], u[2]);
      unit3(u[2]);
    }
    for (int i = 0; i < 3; ++i)
      for (int k = 0; k < 3; ++k) U[i][k] = u[k][i];
  }
  const double d = det3(Vs) * det3(U);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      R[3 * i + j] = (float)(Vs[i][0] * U[j][0] + Vs[i][1] * U[j][1] +
                             d * Vs[i][2] * U[j][2]);
}

__global__ void __launch_bounds__(kThreads, 1)
    ransac_kabsch_kernel(const float* __restrict__ model,
                         const float* __restrict__ cam,
                         const float* __restrict__ mask,
                         const float* __restrict__ uniforms,
                         float* __restrict__ cdf, float* __restrict__ R_out,
                         float* __restrict__ t_out,
                         float* __restrict__ ratio_out,
                         int* __restrict__ best_out, int N, int H, int S,
                         float thr2) {
  extern __shared__ float4 dyn[];
  float* hyp = reinterpret_cast<float*>(dyn);       // [H][12]: R, t
  int* score = reinterpret_cast<int*>(hyp + 12 * H);  // [H]
  float* sm = reinterpret_cast<float*>(score + H);  // chunk: m, c, mask
  __shared__ float red[kWarps * 9];
  __shared__ float out[9];
  __shared__ int best_s[2];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* mb = model + (size_t)b * N * 3;
  const float* cb = cam + (size_t)b * N * 3;
  const float* kb = mask + (size_t)b * N;
  float* cdf_b = cdf + (size_t)b * N;
  const int chunk = N < kChunk ? N : kChunk;

  // 1. the mask's inclusive prefix sum ---------------------------------
  float carry = 0.f;
  for (int base = 0; base < N; base += kThreads) {
    const int i = base + tid;
    float x = i < N ? kb[i] : 0.f;
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
    if (i < N)
      cdf_b[i] = carry + (warp > 0 ? red[kWarps + warp - 1] : 0.f) + x;
    carry += red[2 * kWarps - 1];
    __syncthreads();
  }
  const float total = carry;  // sum(mask)

  // 2. sample and fit, a thread a hypothesis ----------------------------
  const float scale = fmaxf(total, 1.f);
  for (int h = tid; h < H; h += kThreads) {
    float src[3 * kMaxSample], dst[3 * kMaxSample];
    const float* uh = uniforms + ((size_t)b * H + h) * S;
    for (int s = 0; s < S; ++s) {
      const float u = uh[s] * scale;
      int lo = 0, hi = N;  // the first i with cdf[i] >= u
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (cdf_b[mid] < u)
          lo = mid + 1;
        else
          hi = mid;
      }
      const int idx = lo < N - 1 ? lo : N - 1;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        src[3 * s + d] = mb[3 * idx + d];
        dst[3 * s + d] = cb[3 * idx + d];
      }
    }
    horn_fit(src, dst, S, hyp + 12 * h);
    score[h] = 0;
  }
  __syncthreads();

  // 3. score every hypothesis over every point --------------------------
  float* sm_m = sm;
  float* sm_c = sm + 3 * chunk;
  float* sm_k = sm + 6 * chunk;
  const float4* hyp4 = reinterpret_cast<const float4*>(hyp);
  for (int c0 = 0; c0 < N; c0 += chunk) {
    const int n = N - c0 < chunk ? N - c0 : chunk;
    for (int i = tid; i < 3 * n; i += kThreads) {
      sm_m[i] = mb[3 * c0 + i];
      sm_c[i] = cb[3 * c0 + i];
    }
    for (int i = tid; i < n; i += kThreads) sm_k[i] = kb[c0 + i];
    __syncthreads();
    for (int p0 = 0; p0 < n; p0 += kThreads * kPts) {
      float pm[kPts][3], pc[kPts][3];
      bool valid[kPts];
#pragma unroll
      for (int k = 0; k < kPts; ++k) {
        const int i = p0 + k * kThreads + tid;
        valid[k] = i < n && sm_k[i] > 0.f;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          pm[k][d] = i < n ? sm_m[3 * i + d] : 0.f;
          pc[k][d] = i < n ? sm_c[3 * i + d] : 0.f;
        }
      }
      for (int h = 0; h < H; ++h) {
        const float4 q0 = hyp4[3 * h], q1 = hyp4[3 * h + 1],
                     q2 = hyp4[3 * h + 2];
        const float r[12] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y,
                             q1.z, q1.w, q2.x, q2.y, q2.z, q2.w};
        unsigned cnt = 0;
#pragma unroll
        for (int k = 0; k < kPts; ++k)
          cnt += (valid[k] && dist2(r, pm[k][0], pm[k][1], pm[k][2],
                                    pc[k][0], pc[k][1], pc[k][2]) < thr2)
                     ? 1u
                     : 0u;
        cnt = __reduce_add_sync(kFull, cnt);
        if (lane == 0 && cnt) atomicAdd(&score[h], (int)cnt);
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    int bh = 0, bs = score[0];
    for (int h = 1; h < H; ++h)
      if (score[h] > bs) {
        bs = score[h];
        bh = h;
      }
    best_s[0] = bh;
    best_s[1] = bs;
  }
  __syncthreads();
  const int bh = best_s[0], bs = best_s[1];
  const bool use_inl = bs >= S;
  float r[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) r[i] = hyp[12 * bh + i];

  // 4. the weighted refit ------------------------------------------------
  float s7[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = tid; i < N; i += kThreads) {
    const float mx = mb[3 * i], my = mb[3 * i + 1], mz = mb[3 * i + 2];
    const float cx = cb[3 * i], cy = cb[3 * i + 1], cz = cb[3 * i + 2];
    const float k = kb[i];
    const float w =
        use_inl ? ((k > 0.f && dist2(r, mx, my, mz, cx, cy, cz) < thr2) ? 1.f
                                                                        : 0.f)
                : k;
    s7[0] += w;
    s7[1] += mx * w;
    s7[2] += my * w;
    s7[3] += mz * w;
    s7[4] += cx * w;
    s7[5] += cy * w;
    s7[6] += cz * w;
  }
  block_sum(s7, red, out);
  const float wsum = s7[0] + kEps;
  const float cm[3] = {s7[1] / wsum, s7[2] / wsum, s7[3] / wsum};
  const float cc[3] = {s7[4] / wsum, s7[5] / wsum, s7[6] / wsum};
  float s9[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = tid; i < N; i += kThreads) {
    const float mx = mb[3 * i], my = mb[3 * i + 1], mz = mb[3 * i + 2];
    const float cx = cb[3 * i], cy = cb[3 * i + 1], cz = cb[3 * i + 2];
    const float k = kb[i];
    const float w =
        use_inl ? ((k > 0.f && dist2(r, mx, my, mz, cx, cy, cz) < thr2) ? 1.f
                                                                        : 0.f)
                : k;
    const float a[3] = {(mx - cm[0]) * w, (my - cm[1]) * w, (mz - cm[2]) * w};
    const float c[3] = {cx - cc[0], cy - cc[1], cz - cc[2]};
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int q = 0; q < 3; ++q) s9[3 * p + q] += a[p] * c[q];
  }
  block_sum(s9, red, out);
  if (tid == 0) {
    float R[9];
    svd_rotation(s9, R);
    for (int i = 0; i < 9; ++i) R_out[(size_t)b * 9 + i] = R[i];
    for (int i = 0; i < 3; ++i)
      t_out[(size_t)b * 3 + i] =
          cc[i] - (R[3 * i] * cm[0] + R[3 * i + 1] * cm[1] +
                   R[3 * i + 2] * cm[2]);
    ratio_out[b] = (float)bs / fmaxf(total, 1.f);
    best_out[2 * b] = bh;
    best_out[2 * b + 1] = bs;
  }
}

}  // namespace

extern "C" {

// Launches one block a ROI on `stream` of CUDA device `device` (made
// current for the launch, the caller's device restored after). Returns a
// cudaError_t as an int (0 = ok); cudaErrorInvalidValue for shapes this
// file does not take.
int ransac_kabsch_launch(const float* model, const float* cam,
                         const float* mask, const float* uniforms, float* cdf,
                         float* R, float* t, float* ratio, int* best, int B,
                         int N, int H, int S, float thr2, int device,
                         void* stream) {
  if (B <= 0) return 0;
  if (N <= 0 || H <= 0 || S <= 0 || S > kMaxSample ||
      (long long)N * 3 > INT_MAX || smem_bytes(N, H) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  const size_t smem = smem_bytes(N, H);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ransac_kabsch_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess) {
    ransac_kabsch_kernel<<<B, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        model, cam, mask, uniforms, cdf, R, t, ratio, best, N, H, S, thr2);
    err = cudaGetLastError();
  }
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

const char* ransac_kabsch_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
