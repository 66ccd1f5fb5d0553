"""Batched fixed-iteration RANSAC and weighted Kabsch: the CUDA kernel and
its plain version.

Counterpart of ``rdpn6d_tpu/ops/ransac_kabsch.py`` (``kabsch``,
``kabsch_quat``, ``ransac_kabsch``, ``decode_model_coords``,
``refine_pose_kabsch``), the net-initialised geometric refinement of
``test.use_pnp`` with ``test.pnp_type="ransac_kabsch"``. A ROI's dense
model coordinates, decoded with the net's rotation, pair with the camera
points of its depth crop; ``num_hyps`` hypotheses of ``sample_size``
correspondences each are drawn by inverse CDF over the valid mask, fitted
by Horn's quaternion method, scored by their inliers over every valid
point, and the best one's inliers (the mask where it has fewer than
``sample_size``) are refitted by the weighted SVD Kabsch.

The draws are inputs: ``hypothesis_draws`` makes the [B, H, S] table of
uniforms in [0, 1) from a generator seeded 0, the same table for every
batch of a given size, as the JAX package draws from ``PRNGKey(0)`` split
over the batch (other numbers; tests hand both the same table).

``ransac_kabsch`` picks by the tensors' device: CPU tensors take the plain
version, ``ransac_kabsch_plain``, which follows the JAX package op for op
(the expanded d² of its matmul scoring, in its order of terms); CUDA
tensors launch ``csrc/ransac_kabsch.cu`` (built with nvcc at first use),
one launch a batch, or raise. The kernel computes d² in the direct form
|R m + t - c|², so a d² within rounding of the threshold can count on one
side only. Both return the pre-fallback fit with the best hypothesis and
its score; ``refine_pose_kabsch`` falls back to the net pose where
``ratio <= 0.05``.

NaN: a NaN point makes the weighted sums NaN even where its weight is 0
(``src * w`` is NaN * 0), and so the refit's R and t, as in the JAX
package; the plain version's SVD is taken on a finite stand-in there and
its R set to NaN, since ``torch.linalg.svd`` refuses non-finite input.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import cuda_build
from .region import gather_region_fps

KERNEL = "ransac_kabsch"
NUM_HYPS = 128           # the JAX package's defaults for the eval step
SAMPLE_SIZE = 4
CHUNK = 4096             # points staged in shared memory at once (kChunk)
MAX_SAMPLE = 16          # correspondences a hypothesis (kMaxSample)
MAX_SMEM = 232448        # a block's shared memory on sm_90 (kMaxSmem)
HORN_ITERS = 14          # normalised squarings of Horn's 4x4 matrix
EPS = 1e-9
REFINE_MIN_RATIO = 0.05  # below it the net pose is kept


class RansacResult(NamedTuple):
    R: torch.Tensor       # [B, 3, 3] the refit, before any fallback
    t: torch.Tensor       # [B, 3]
    ratio: torch.Tensor   # [B] best score / max(sum(mask), 1)
    best: torch.Tensor    # [B] int64, the best hypothesis (lowest on ties)
    score: torch.Tensor   # [B] int64, its inliers


class Refined(NamedTuple):
    R: torch.Tensor       # [B, 3, 3] refined, or the net's where not ok
    t: torch.Tensor       # [B, 3]
    ratio: torch.Tensor   # [B]
    fit: RansacResult     # the pre-fallback fit


def hypothesis_draws(b: int, num_hyps: int, sample_size: int,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    """[b, num_hyps, sample_size] float32 uniforms in [0, 1) from a CPU
    generator seeded 0: the same table for every batch of size ``b``, on
    every device."""
    gen = torch.Generator().manual_seed(0)
    return torch.rand((b, num_hyps, sample_size), generator=gen).to(device)


def _centred(src, dst, weights, eps):
    w = weights[..., None]
    wsum = w.sum(-2) + eps
    c_src = (src * w).sum(-2) / wsum
    c_dst = (dst * w).sum(-2) / wsum
    a = src - c_src[..., None, :]
    b = dst - c_dst[..., None, :]
    H = torch.einsum("...ni,...n,...nj->...ij", a, weights, b)
    return c_src, c_dst, H


def kabsch(src: torch.Tensor, dst: torch.Tensor,
           weights: torch.Tensor | None = None,
           eps: float = EPS) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted least-squares rigid transform R @ src + t ~= dst by SVD,
    the determinant corrected: R = V diag(1, 1, det(V U^T)) U^T.
    src/dst [..., N, 3], weights [..., N] >= 0 -> R [..., 3, 3], t [..., 3].
    A non-finite covariance gives NaN R and t."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype,
                             device=src.device)
    c_src, c_dst, H = _centred(src, dst, weights, eps)
    finite = torch.isfinite(H).all(-1).all(-1)
    U, _, Vh = torch.linalg.svd(torch.where(finite[..., None, None], H,
                                            torch.zeros_like(H)))
    V, Ut = Vh.transpose(-1, -2), U.transpose(-1, -2)
    det = torch.linalg.det(V @ Ut)
    D = torch.diag_embed(torch.stack(
        [torch.ones_like(det), torch.ones_like(det), det], -1))
    R = V @ D @ Ut
    R = torch.where(finite[..., None, None], R,
                    torch.full_like(R, float("nan")))
    t = c_dst - torch.einsum("...ij,...j->...i", R, c_src)
    return R, t


def quat_rotation(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] unit (w, x, y, z) -> [..., 3, 3]."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
                     2 * (qx * qz + qw * qy)], -1),
        torch.stack([2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
                     2 * (qy * qz - qw * qx)], -1),
        torch.stack([2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
                     1 - 2 * (qx * qx + qy * qy)], -1),
    ], -2)


def kabsch_quat(src: torch.Tensor, dst: torch.Tensor,
                weights: torch.Tensor | None = None,
                n_iters: int = HORN_ITERS,
                eps: float = EPS) -> tuple[torch.Tensor, torch.Tensor]:
    """Horn's quaternion fit, SVD-free: the dominant eigenvector of the
    symmetric 4x4 K, shifted to a non-negative spectrum and driven out by
    ``n_iters`` normalised squarings; the column of largest norm (the
    first of equal ones) is the quaternion. Same contract as
    :func:`kabsch`; always a proper rotation."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype,
                             device=src.device)
    c_src, c_dst, H = _centred(src, dst, weights, eps)
    Sxx, Sxy, Sxz = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    Syx, Syy, Syz = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    Szx, Szy, Szz = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    K = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, Syy - Sxx - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, Szz - Sxx - Syy], -1),
    ], -2)
    fro = torch.sqrt((K * K).sum((-2, -1), keepdim=True)) + eps
    M = K / fro + torch.eye(4, dtype=K.dtype, device=K.device)
    for _ in range(n_iters):
        M = M @ M
        M = M / (torch.sqrt((M * M).sum((-2, -1), keepdim=True)) + eps)
    j = torch.sqrt((M * M).sum(-2)).argmax(-1)
    q = torch.take_along_dim(M, j[..., None, None].expand(
        M.shape[:-1] + (1,)), dim=-1)[..., 0]
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + eps)
    R = quat_rotation(q)
    t = c_dst - torch.einsum("...ij,...j->...i", R, c_src)
    return R, t


def hypothesis_picks(mask: torch.Tensor,
                     uniforms: torch.Tensor) -> torch.Tensor:
    """The correspondences each hypothesis draws: mask [B, N], uniforms
    [B, H, S] -> int64 [B, H, S], the left insertion point of u * max(
    sum(mask), 1) into the mask's float32 prefix sum, clipped to N - 1 (an
    all-zero mask picks as ``searchsorted`` does)."""
    B, N = mask.shape
    cdf = torch.cumsum(mask.float(), -1)
    total = cdf[:, -1].clamp_min(1.0)
    u = uniforms * total[:, None, None]
    idx = torch.searchsorted(cdf, u.reshape(B, -1))
    return idx.clamp(0, N - 1).reshape(uniforms.shape)


def _threshold_sq(inlier_thr: float) -> torch.Tensor:
    # thr * thr in float32, as the JAX package squares its float32 argument
    thr = torch.tensor(inlier_thr, dtype=torch.float32)
    return thr * thr


def ransac_kabsch_plain(model_pts: torch.Tensor, cam_pts: torch.Tensor,
                        mask: torch.Tensor, uniforms: torch.Tensor,
                        inlier_thr: float = 0.01) -> RansacResult:
    """The plain PyTorch version: model_pts / cam_pts [B, N, 3], mask
    [B, N] (1 = valid), uniforms [B, H, S] -> :class:`RansacResult`."""
    B, N, _ = model_pts.shape
    H, S = uniforms.shape[1:]
    idx = hypothesis_picks(mask, uniforms).reshape(B, H * S, 1)
    src = torch.take_along_dim(model_pts, idx, 1).reshape(B, H, S, 3)
    dst = torch.take_along_dim(cam_pts, idx, 1).reshape(B, H, S, 3)
    R_h, t_h = kabsch_quat(src, dst)                     # [B,H,3,3], [B,H,3]

    # the JAX package's matmul form of |R m + t - c|², its order of terms
    m2 = (model_pts * model_pts).sum(-1)                 # [B, N]
    c2 = (cam_pts * cam_pts).sum(-1)
    outer = (cam_pts[..., :, None]
             * model_pts[..., None, :]).reshape(B, N, 9)  # c m^T
    cross = R_h.reshape(B, H, 9) @ outer.transpose(1, 2)  # [B, H, N]
    Rt_t = torch.einsum("bhji,bhj->bhi", R_h, t_h)        # R^T t
    t2 = (t_h * t_h).sum(-1)                              # [B, H]
    d2 = (m2[:, None] + c2[:, None] + t2[..., None]
          + 2.0 * (Rt_t @ model_pts.transpose(1, 2))
          - 2.0 * cross
          - 2.0 * (t_h @ cam_pts.transpose(1, 2)))
    inl = (d2 < _threshold_sq(inlier_thr).to(d2.device)) \
        & (mask[:, None] > 0)
    score = inl.sum(-1)                                   # [B, H]
    best = score.argmax(-1)
    b = torch.arange(B, device=mask.device)
    w = inl[b, best].to(model_pts.dtype)
    w = torch.where(w.sum(-1, keepdim=True) >= S, w, mask.to(w.dtype))
    R, t = kabsch(model_pts, cam_pts, w)
    best_score = score[b, best]
    ratio = best_score / mask.sum(-1).clamp_min(1.0)
    return RansacResult(R, t, ratio, best, best_score)


def _check(model_pts, cam_pts, mask, uniforms) -> None:
    dev = model_pts.device
    if any(x.device != dev for x in (cam_pts, mask, uniforms)):
        raise ValueError("ransac_kabsch: inputs on different devices")
    if any(x.dtype != torch.float32
           for x in (model_pts, cam_pts, mask, uniforms)):
        raise TypeError("ransac_kabsch: float32 inputs required")
    if model_pts.dim() != 3 or model_pts.shape[-1] != 3 \
            or cam_pts.shape != model_pts.shape \
            or mask.shape != model_pts.shape[:2] or uniforms.dim() != 3 \
            or uniforms.shape[0] != model_pts.shape[0]:
        raise ValueError(
            f"ransac_kabsch: expected model/cam [B,N,3], mask [B,N], "
            f"uniforms [B,H,S]; got {tuple(model_pts.shape)}, "
            f"{tuple(cam_pts.shape)}, {tuple(mask.shape)}, "
            f"{tuple(uniforms.shape)}")
    if model_pts.shape[1] == 0 or uniforms.shape[1] == 0 \
            or uniforms.shape[2] == 0:
        raise ValueError("ransac_kabsch: no points or no hypotheses")


def shared_bytes(N: int, H: int) -> int:
    """Dynamic shared memory of a launch (``smem_bytes`` in the source): a
    chunk of points (xyz + xyz + mask) and each hypothesis's R, t and
    score."""
    return 7 * min(N, CHUNK) * 4 + H * 16 * 4


def _launch(model_pts, cam_pts, mask, uniforms, inlier_thr) -> RansacResult:
    """Launch the kernel on the current stream: one block a ROI."""
    B, N, _ = model_pts.shape
    H, S = uniforms.shape[1:]
    if S > MAX_SAMPLE or shared_bytes(N, H) > MAX_SMEM:
        raise ValueError(f"ransac_kabsch: the kernel takes at most "
                         f"{MAX_SAMPLE} correspondences a hypothesis and "
                         f"{(MAX_SMEM - 7 * CHUNK * 4) // 64} hypotheses; "
                         f"got {H} of {S}")
    lib, _ = cuda_build.load(KERNEL)
    model_pts, cam_pts, mask, uniforms = (
        x.contiguous() for x in (model_pts, cam_pts, mask, uniforms))
    dev = model_pts.device
    R = torch.empty((B, 3, 3), dtype=torch.float32, device=dev)
    t = torch.empty((B, 3), dtype=torch.float32, device=dev)
    ratio = torch.empty((B,), dtype=torch.float32, device=dev)
    best = torch.empty((B, 2), dtype=torch.int32, device=dev)
    cdf = torch.empty((B, N), dtype=torch.float32, device=dev)
    if B:
        fn = lib.ransac_kabsch_launch
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 \
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        err = fn(model_pts.data_ptr(), cam_pts.data_ptr(), mask.data_ptr(),
                 uniforms.data_ptr(), cdf.data_ptr(), R.data_ptr(),
                 t.data_ptr(), ratio.data_ptr(), best.data_ptr(), B, N, H,
                 S, float(_threshold_sq(inlier_thr)), index,
                 torch._C._cuda_getCurrentRawStream(index))
        if err != 0:
            lib.ransac_kabsch_error_string.restype = ctypes.c_char_p
            lib.ransac_kabsch_error_string.argtypes = [ctypes.c_int]
            msg = lib.ransac_kabsch_error_string(err).decode()
            raise RuntimeError(
                f"ransac_kabsch kernel launch failed: {msg} ({err})")
        cuda_build.count_launch(KERNEL)
    best = best.long()
    return RansacResult(R, t, ratio, best[:, 0], best[:, 1])


def ransac_kabsch(model_pts: torch.Tensor, cam_pts: torch.Tensor,
                  mask: torch.Tensor, uniforms: torch.Tensor,
                  inlier_thr: float = 0.01) -> RansacResult:
    """Robust rigid fit of each ROI's masked correspondences: model_pts /
    cam_pts [B, N, 3], mask [B, N], uniforms [B, H, S], all float32.
    CPU tensors take the plain version, CUDA tensors the kernel."""
    _check(model_pts, cam_pts, mask, uniforms)
    if model_pts.device.type == "cpu":
        return ransac_kabsch_plain(model_pts, cam_pts, mask, uniforms,
                                   inlier_thr)
    if model_pts.device.type == "cuda":
        return _launch(model_pts, cam_pts, mask, uniforms, inlier_thr)
    raise ValueError(f"ransac_kabsch: no kernel for device "
                     f"{model_pts.device}")


def decode_model_coords(coord: torch.Tensor, region_logits: torch.Tensor,
                        fps: torch.Tensor, extent: torch.Tensor,
                        rot_est: torch.Tensor) -> torch.Tensor:
    """Model-frame points from the residual coordinates and a rotation
    estimate: R_est^T ((coord - 0.5) * extent) + fps[argmax region].
    coord [B,H,W,3], region_logits [B,H,W,K+1], fps [B,K,3], extent [B,3],
    rot_est [B,3,3] -> [B,H,W,3]."""
    region_ids = region_logits[..., 1:].argmax(-1)
    fps_sel = gather_region_fps(fps, region_ids)
    delta = torch.einsum("bji,bhwj->bhwi", rot_est,
                         (coord - 0.5) * extent[:, None, None, :])
    return delta + fps_sel


def refine_pose_kabsch(coord: torch.Tensor, region_logits: torch.Tensor,
                       mask_prob: torch.Tensor, depth_xyz: torch.Tensor,
                       resize_ratio: torch.Tensor, fps: torch.Tensor,
                       extent: torch.Tensor, rot_net: torch.Tensor,
                       trans_net: torch.Tensor, uniforms: torch.Tensor,
                       mask_thr: float = 0.5,
                       inlier_thr: float = 0.015) -> Refined:
    """Net-initialised RANSAC-Kabsch refinement of a batch of ROIs, in
    float32: coord / region_logits / mask_prob [B,H,W(,*)] at head
    resolution, depth_xyz [B,H,W,3] (the crop's scaled back-projection),
    resize_ratio [B], fps [B,K,3], extent [B,3], the net pose rot_net
    [B,3,3] / trans_net [B,3] (which decodes the residuals and stands
    where ``ratio <= 0.05``), uniforms [B, num_hyps, 4]."""
    B = coord.shape[0]
    f32 = [x.float() for x in (coord, region_logits, mask_prob, depth_xyz,
                               resize_ratio, fps, extent, rot_net,
                               trans_net)]
    coord, region_logits, mask_prob, depth_xyz, resize_ratio, fps, \
        extent, rot_net, trans_net = f32
    cam_pts = (depth_xyz * resize_ratio[:, None, None, None]).reshape(
        B, -1, 3)
    model_pts = decode_model_coords(coord, region_logits, fps, extent,
                                    rot_net).reshape(B, -1, 3)
    valid = (mask_prob.reshape(B, -1) > mask_thr) & (cam_pts[..., 2] > 1e-3)
    fit = ransac_kabsch(model_pts.contiguous(), cam_pts.contiguous(),
                        valid.float(), uniforms, inlier_thr)
    ok = fit.ratio > REFINE_MIN_RATIO
    R = torch.where(ok[:, None, None], fit.R, rot_net)
    t = torch.where(ok[:, None], fit.t, trans_net)
    return Refined(R, t, fit.ratio, fit)
