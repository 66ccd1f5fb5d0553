// Software triangle rasterizer: depth and model-coordinate maps of a mesh.
//
// The port's own copy of the JAX package's host rasterizer (the reference
// renders with offscreen OpenGL/EGL; this needs no GL context):
// perspective projection and edge-function rasterization with a z-buffer
// and perspective-correct barycentric interpolation of the model-frame
// vertex coordinates. Host C++, no CUDA: VSD's depth renders.
//
// Built at first use by rdpn6d_tpu_torch/ops/cuda_build.py build_host()
// with the host compiler at fixed flags (-O3 -fPIC -shared -std=c++17
// -ffp-contract=off, no -march=native), so a render does not depend on the
// machine, and loaded with ctypes by rdpn6d_tpu_torch/ops/rasterizer.py.

#include <algorithm>
#include <cmath>
#include <cstring>
#include <limits>

namespace {

struct Vec3 {
  float x, y, z;
};

inline Vec3 transform(const float* R, const float* t, const Vec3& p) {
  return {R[0] * p.x + R[1] * p.y + R[2] * p.z + t[0],
          R[3] * p.x + R[4] * p.y + R[5] * p.z + t[1],
          R[6] * p.x + R[7] * p.y + R[8] * p.z + t[2]};
}

inline float edge(float ax, float ay, float bx, float by, float cx,
                  float cy) {
  return (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
}

}  // namespace

extern "C" {

// verts: [nv, 3] model-frame vertices (any unit; meters for BOP use)
// faces: [nf, 3] vertex indices
// K: [9] row-major intrinsics; R: [9] row-major rotation; t: [3]
// depth_out: [H*W] camera-space z (0 = background)
// xyz_out:   [H*W*3] model-frame coordinates of the visible surface
void render_mesh(const float* verts, int nv, const int* faces, int nf,
                 const float* K, const float* R, const float* t, int H,
                 int W, float* depth_out, float* xyz_out) {
  const float fx = K[0], cx = K[2], fy = K[4], cy = K[5];
  std::fill(depth_out, depth_out + H * W, 0.0f);
  std::fill(xyz_out, xyz_out + H * W * 3, 0.0f);

  // z-buffer initialised to +inf
  float* zbuf = new float[H * W];
  std::fill(zbuf, zbuf + H * W, std::numeric_limits<float>::infinity());

  // pre-transform vertices to camera frame and project
  float* cam = new float[nv * 3];
  float* scr = new float[nv * 2];
  for (int i = 0; i < nv; ++i) {
    Vec3 p{verts[3 * i], verts[3 * i + 1], verts[3 * i + 2]};
    Vec3 c = transform(R, t, p);
    cam[3 * i] = c.x;
    cam[3 * i + 1] = c.y;
    cam[3 * i + 2] = c.z;
    const float inv_z = c.z > 1e-9f ? 1.0f / c.z : 0.0f;
    scr[2 * i] = fx * c.x * inv_z + cx;
    scr[2 * i + 1] = fy * c.y * inv_z + cy;
  }

  for (int f = 0; f < nf; ++f) {
    const int i0 = faces[3 * f], i1 = faces[3 * f + 1], i2 = faces[3 * f + 2];
    const float z0 = cam[3 * i0 + 2], z1 = cam[3 * i1 + 2],
                z2 = cam[3 * i2 + 2];
    // near-plane cull: estimated poses can be arbitrary garbage, and a
    // vertex just in front of the camera projects to coordinates whose
    // float->int cast is UB (and whose bbox spans the whole image)
    if (z0 <= 1e-4f || z1 <= 1e-4f || z2 <= 1e-4f) continue;

    const float x0 = scr[2 * i0], y0 = scr[2 * i0 + 1];
    const float x1 = scr[2 * i1], y1 = scr[2 * i1 + 1];
    const float x2 = scr[2 * i2], y2 = scr[2 * i2 + 1];

    const float area = edge(x0, y0, x1, y1, x2, y2);
    if (std::fabs(area) < 1e-12f) continue;
    const float inv_area = 1.0f / area;

    // clamp in FLOAT domain first: casting a huge/non-finite float to
    // int is undefined behavior
    const float fx0 = std::min({x0, x1, x2}), fx1 = std::max({x0, x1, x2});
    const float fy0 = std::min({y0, y1, y2}), fy1 = std::max({y0, y1, y2});
    if (!std::isfinite(fx0) || !std::isfinite(fx1) ||
        !std::isfinite(fy0) || !std::isfinite(fy1)) continue;
    int xmin = (int)std::floor(std::fmax(0.0f, std::fmin(fx0, (float)(W - 1))));
    int xmax = (int)std::ceil(std::fmax(0.0f, std::fmin(fx1, (float)(W - 1))));
    int ymin = (int)std::floor(std::fmax(0.0f, std::fmin(fy0, (float)(H - 1))));
    int ymax = (int)std::ceil(std::fmax(0.0f, std::fmin(fy1, (float)(H - 1))));
    if (fx1 < 0.0f || fx0 > (float)(W - 1) ||
        fy1 < 0.0f || fy0 > (float)(H - 1)) continue;

    const float iz0 = 1.0f / z0, iz1 = 1.0f / z1, iz2 = 1.0f / z2;

    for (int y = ymin; y <= ymax; ++y) {
      for (int x = xmin; x <= xmax; ++x) {
        // pixel centers AT INTEGER coordinates: the cv2-convention K
        // used across this code base (pipeline backprojection u=arange)
        // samples there; OpenGL's half-pixel centers would shift renders
        // against the captured depth
        const float px = (float)x, py = (float)y;
        float w0 = edge(x1, y1, x2, y2, px, py) * inv_area;
        float w1 = edge(x2, y2, x0, y0, px, py) * inv_area;
        float w2 = 1.0f - w0 - w1;
        // inside test robust to either winding (area sign folded in)
        if (w0 < 0.0f || w1 < 0.0f || w2 < 0.0f) continue;

        // perspective-correct: interpolate 1/z and attrs/z
        const float inv_z = w0 * iz0 + w1 * iz1 + w2 * iz2;
        const float z = 1.0f / inv_z;
        const int idx = y * W + x;
        if (z >= zbuf[idx]) continue;
        zbuf[idx] = z;
        depth_out[idx] = z;
        const float a0 = w0 * iz0 * z, a1 = w1 * iz1 * z,
                    a2 = w2 * iz2 * z;
        for (int c = 0; c < 3; ++c) {
          xyz_out[3 * idx + c] = a0 * verts[3 * i0 + c] +
                                 a1 * verts[3 * i1 + c] +
                                 a2 * verts[3 * i2 + c];
        }
      }
    }
  }
  delete[] zbuf;
  delete[] cam;
  delete[] scr;
}

}  // extern "C"
