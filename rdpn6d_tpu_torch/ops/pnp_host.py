"""Host 2D-3D PnP: EPnP, RANSAC over it and a Levenberg-Marquardt
refinement, in numpy float64.

Counterpart of ``rdpn6d_tpu/ops/pnp_host.py`` (the reference's
lib/pysixd/misc.py:145-195 ``pnp_v2``: OpenCV's EPnP + RANSAC, then the
iterative refinement on the inliers; and the evaluator's correspondence
extraction, gdrn_evaluator.py:89-126). The GPU machine has no OpenCV, so
the solvers are written here:

  * EPnP (Lepetit, Moreno-Noguer and Fua, 2009): four control points (the
    centroid and the principal axes), each point's barycentric weights,
    the 2n x 12 system's null space (the four eigenvectors of MᵀM of
    least eigenvalue), the betas by the N = 1, 2, 3 and 4 approximations,
    each refined by Gauss-Newton, and the pose of the one with the least
    reprojection error (absolute orientation by SVD).
  * RANSAC: ``iterations`` samples of 5 from a seeded
    ``numpy.random.Generator``, EPnP on each, inliers within
    ``reprojection_error`` pixels; EPnP on the best sample's inliers, as
    OpenCV's solvePnPRansac ends.
  * The refinement: Levenberg-Marquardt on the squared reprojection
    error over the inliers, in Rodrigues parameters and translation.

``method="iterative"`` is the refinement started from EPnP on all points.
Fewer than 4 points give the identity fallback, as the JAX package's.
The port's eval prefers the card's RANSAC-Kabsch
(``ops/ransac_kabsch.py``); these functions are for cross-checks and
RGB-only use.
"""

from __future__ import annotations

import numpy as np

SAMPLE = 5                  # OpenCV's minimal set for EPnP in RANSAC
_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _fallback():
    return np.eye(3, dtype=np.float32), np.zeros(3, np.float32)


def rodrigues(r: np.ndarray) -> np.ndarray:
    """Axis-angle vector -> rotation matrix."""
    theta = float(np.linalg.norm(r))
    k = np.array([[0.0, -r[2], r[1]], [r[2], 0.0, -r[0]],
                  [-r[1], r[0], 0.0]])
    if theta < 1e-12:
        return np.eye(3) + k
    k /= theta
    return np.eye(3) + np.sin(theta) * k + (1 - np.cos(theta)) * (k @ k)


def rotation_to_rodrigues(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> axis-angle vector (angle in [0, pi])."""
    c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = float(np.arccos(c))
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    if theta < 1e-8:
        return w / 2.0
    if np.pi - theta < 1e-4:
        # near pi: the axis from the symmetric part, its sign from w
        B = (R + np.eye(3)) / 2.0
        axis = np.sqrt(np.clip(np.diag(B), 0.0, None))
        i = int(axis.argmax())
        axis = B[i] / axis[i]
        if w @ axis < 0:
            axis = -axis
        return axis / np.linalg.norm(axis) * theta
    return w / (2.0 * np.sin(theta)) * theta


def _project(K, R, t, p3):
    cam = p3 @ R.T + t
    uv = cam @ K.T
    return uv[:, :2] / uv[:, 2:3]


def _errors(K, R, t, p3, p2):
    return np.linalg.norm(_project(K, R, t, p3) - p2, axis=1)


def _absolute_orientation(pc, pw):
    """(R, t) with pc ≈ R pw + t (least squares, a proper rotation)."""
    cc, cw = pc.mean(0), pw.mean(0)
    H = (pc - cc).T @ (pw - cw)
    U, _, Vt = np.linalg.svd(H)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    return R, cc - R @ cw


def _control_points(pw):
    c0 = pw.mean(0)
    d = pw - c0
    w, V = np.linalg.eigh(d.T @ d / len(pw))
    axes = (V * np.sqrt(np.maximum(w, 0.0))).T[::-1]
    return np.vstack([c0, c0 + axes])


def _betas_l(vs):
    """L (6 x 10) of the control-point distances in the null space."""
    dv = [np.array([v[a] - v[b] for a, b in _PAIRS]) for v in vs]
    d = [[np.einsum("ij,ij->i", dv[a], dv[b]) for b in range(4)]
         for a in range(4)]
    return np.stack([d[0][0], 2 * d[0][1], d[1][1], 2 * d[0][2],
                     2 * d[1][2], d[2][2], 2 * d[0][3], 2 * d[1][3],
                     2 * d[2][3], d[3][3]], 1)


def _beta_products(b):
    return np.array([b[0] * b[0], b[0] * b[1], b[1] * b[1], b[0] * b[2],
                     b[1] * b[2], b[2] * b[2], b[0] * b[3], b[1] * b[3],
                     b[2] * b[3], b[3] * b[3]])


def _gauss_newton(L, rho, b, iters: int = 5):
    b = np.array(b, float)
    for _ in range(iters):
        A = np.stack([
            2 * L[:, 0] * b[0] + L[:, 1] * b[1] + L[:, 3] * b[2]
            + L[:, 6] * b[3],
            L[:, 1] * b[0] + 2 * L[:, 2] * b[1] + L[:, 4] * b[2]
            + L[:, 7] * b[3],
            L[:, 3] * b[0] + L[:, 4] * b[1] + 2 * L[:, 5] * b[2]
            + L[:, 8] * b[3],
            L[:, 6] * b[0] + L[:, 7] * b[1] + L[:, 8] * b[2]
            + 2 * L[:, 9] * b[3]], 1)
        r = rho - L @ _beta_products(b)
        b = b + np.linalg.lstsq(A, r, rcond=None)[0]
    return b


def _beta_guesses(L, rho, vs, cw):
    """The N = 1, 2, 3 and 4 approximations of the betas."""
    out = []
    # N = 1: one null vector, scaled to the world's control distances
    dc = np.array([np.linalg.norm(vs[0][a] - vs[0][b]) for a, b in _PAIRS])
    dw = np.array([np.linalg.norm(cw[a] - cw[b]) for a, b in _PAIRS])
    out.append([dc @ dw / max(dc @ dc, 1e-300), 0.0, 0.0, 0.0])
    # N = 2: [b11 b12 b22]
    x = np.linalg.lstsq(L[:, [0, 1, 2]], rho, rcond=None)[0]
    b0 = np.sqrt(abs(x[0]))
    b1 = np.sqrt(-x[2]) if x[0] < 0 and x[2] < 0 else \
        np.sqrt(x[2]) if x[0] >= 0 and x[2] > 0 else 0.0
    out.append([-b0 if x[1] < 0 else b0, b1, 0.0, 0.0])
    # N = 3: [b11 b12 b22 b13 b23]
    x = np.linalg.lstsq(L[:, :5], rho, rcond=None)[0]
    b0 = np.sqrt(abs(x[0]))
    b1 = np.sqrt(-x[2]) if x[0] < 0 and x[2] < 0 else \
        np.sqrt(x[2]) if x[0] >= 0 and x[2] > 0 else 0.0
    b0 = -b0 if x[1] < 0 else b0
    out.append([b0, b1, x[3] / b0 if b0 else 0.0, 0.0])
    # N = 4, linearized: [b11 b12 b13 b14]
    x = np.linalg.lstsq(L[:, [0, 1, 3, 6]], rho, rcond=None)[0]
    b0 = np.sqrt(abs(x[0]))
    s = -1.0 if x[0] < 0 else 1.0
    out.append([b0] + [s * x[i] / b0 if b0 else 0.0 for i in (1, 2, 3)])
    return out


def epnp(p3: np.ndarray, p2: np.ndarray, K: np.ndarray
         ) -> tuple[np.ndarray, np.ndarray]:
    """EPnP on n >= 4 correspondences (float64): (R [3,3], t [3])."""
    cw = _control_points(p3)
    C = (cw[1:] - cw[0]).T
    alphas = np.linalg.pinv(C) @ (p3 - cw[0]).T
    alphas = np.vstack([1.0 - alphas.sum(0), alphas]).T        # [n, 4]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    n = len(p3)
    M = np.zeros((2 * n, 12))
    for j in range(4):
        M[0::2, 3 * j] = alphas[:, j] * fx
        M[0::2, 3 * j + 2] = alphas[:, j] * (cx - p2[:, 0])
        M[1::2, 3 * j + 1] = alphas[:, j] * fy
        M[1::2, 3 * j + 2] = alphas[:, j] * (cy - p2[:, 1])
    _, V = np.linalg.eigh(M.T @ M)
    vs = [V[:, i].reshape(4, 3) for i in range(4)]   # least eigenvalue first
    L = _betas_l(vs)
    rho = np.array([np.sum((cw[a] - cw[b]) ** 2) for a, b in _PAIRS])
    best = None
    for guess in _beta_guesses(L, rho, vs, cw):
        b = _gauss_newton(L, rho, guess)
        cc = sum(b[i] * vs[i] for i in range(4))
        pc = alphas @ cc
        if pc[0, 2] < 0:
            pc = -pc
        R, t = _absolute_orientation(pc, p3)
        err = float(np.mean(_errors(K, R, t, p3, p2)))
        if best is None or err < best[0]:
            best = (err, R, t)
    return best[1], best[2]


def refine_lm(p3: np.ndarray, p2: np.ndarray, K: np.ndarray, R: np.ndarray,
              t: np.ndarray, iters: int = 50
              ) -> tuple[np.ndarray, np.ndarray]:
    """Levenberg-Marquardt on the summed squared reprojection error, over
    the Rodrigues vector of R and t, from (R, t)."""
    fx, fy = K[0, 0], K[1, 1]

    def residual(x):
        return (_project(K, rodrigues(x[:3]), x[3:], p3) - p2).ravel()

    def jacobian(x):
        # d(uv)/d(cam) and d(cam)/dt analytically, d(cam)/dr by central
        # differences of the Rodrigues map
        R0 = rodrigues(x[:3])
        cam = p3 @ R0.T + x[3:]
        z = cam[:, 2]
        duv = np.zeros((len(p3), 2, 3))
        duv[:, 0, 0] = fx / z
        duv[:, 0, 2] = -fx * cam[:, 0] / z ** 2
        duv[:, 1, 1] = fy / z
        duv[:, 1, 2] = -fy * cam[:, 1] / z ** 2
        J = np.zeros((2 * len(p3), 6))
        J[:, 3:] = duv.reshape(-1, 3)
        for k in range(3):
            h = 1e-6
            e = np.zeros(3)
            e[k] = h
            dcam = (p3 @ rodrigues(x[:3] + e).T
                    - p3 @ rodrigues(x[:3] - e).T) / (2 * h)
            J[:, k] = np.einsum("nij,nj->ni", duv, dcam).ravel()
        return J

    x = np.concatenate([rotation_to_rodrigues(R), t])
    r = residual(x)
    cost = float(r @ r)
    lam = 1e-3
    for _ in range(iters):
        J = jacobian(x)
        A = J.T @ J
        g = J.T @ r
        while True:
            step = np.linalg.solve(A + lam * np.diag(np.diag(A) + 1e-12),
                                   -g)
            xn = x + step
            rn = residual(xn)
            cn = float(rn @ rn)
            if np.isfinite(cn) and cn <= cost:
                lam = max(lam / 10.0, 1e-12)
                break
            lam *= 10.0
            if lam > 1e12:
                return rodrigues(x[:3]), x[3:]
        done = cost - cn <= 1e-15 * max(cost, 1e-300) or \
            np.abs(step).max() <= 1e-14
        x, r, cost = xn, rn, cn
        if done:
            break
    return rodrigues(x[:3]), x[3:]


def pnp_ransac(points_3d: np.ndarray, points_2d: np.ndarray,
               K: np.ndarray, method: str = "ransac_epnp",
               reprojection_error: float = 3.0, iterations: int = 100,
               rng: np.random.Generator | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
    """Solve (R, t) from 2D-3D correspondences. Returns R [3,3], t [3]
    (float32); the identity and zero where it cannot (fewer than 4
    points, or no sample with 4 inliers). ``rng`` draws the RANSAC
    samples (default: a Generator seeded 0)."""
    p3 = np.asarray(points_3d, np.float64).reshape(-1, 3)
    p2 = np.asarray(points_2d, np.float64).reshape(-1, 2)
    K = np.asarray(K, np.float64)
    n = len(p3)
    if n < 4:
        # a tiny/empty predicted mask legitimately yields < 4 points
        return _fallback()
    if method == "iterative":
        R, t = refine_lm(p3, p2, K, *epnp(p3, p2, K))
    else:
        rng = np.random.default_rng(0) if rng is None else rng
        best = None
        for _ in range(iterations):
            idx = rng.choice(n, min(SAMPLE, n), replace=False)
            R, t = epnp(p3[idx], p2[idx], K)
            inl = _errors(K, R, t, p3, p2) < reprojection_error
            count = int(inl.sum())
            if best is None or count > best[0]:
                best = (count, inl)
        if best[0] < 4:
            return _fallback()
        sel = best[1]
        R, t = epnp(p3[sel], p2[sel], K)
        # the refinement on the INLIERS (pnp_v2): all points would pull
        # the pose back toward the outliers RANSAC rejected
        R, t = refine_lm(p3[sel], p2[sel], K, R, t)
    if not (np.isfinite(R).all() and np.isfinite(t).all()):
        return _fallback()
    return R.astype(np.float32), t.astype(np.float32)


def correspondences_from_maps(coord_model: np.ndarray, mask: np.ndarray,
                              bbox_center: np.ndarray, scale: float,
                              out_res: int | None = None,
                              max_points: int = 2000,
                              seed: int = 0
                              ) -> tuple[np.ndarray, np.ndarray]:
    """Dense-map -> (points_3d, points_2d) in ORIGINAL image pixels.

    coord_model [H, W, 3] model-frame coordinates at head resolution; the
    2D pixel of map cell (r, c) is the inverse of the crop affine
    (gdrn_evaluator.py:89-126). ``out_res`` defaults to the map's own
    resolution — a mismatched explicit value would silently scale the 2D
    points wrong.
    """
    H, W = mask.shape
    if out_res is None:
        out_res = H
    ys, xs = np.nonzero(mask > 0)
    if len(xs) == 0:
        return np.zeros((0, 3)), np.zeros((0, 2))
    if len(xs) > max_points:
        idx = np.random.RandomState(seed).choice(len(xs), max_points,
                                                 replace=False)
        ys, xs = ys[idx], xs[idx]
    p3 = coord_model[ys, xs]
    r = scale / out_res
    u = bbox_center[0] + (xs - out_res / 2.0) * r
    v = bbox_center[1] + (ys - out_res / 2.0) * r
    return p3, np.stack([u, v], -1)
