"""Seeded RGB-D scenes on the device: the benchmark's inputs.

Everything is drawn from one ``torch.Generator`` on the device in a few
large calls. Each class is a box of its own extent (``extent_range``
metres a side), with ``num_points`` model points on its surface, FPS
keypoints over them and, where the configuration names them, a symmetry
bank. Each ROI places its class at a random rotation and a depth in
``z_range``, its centre projected at a uniform pixel of the frame; a ray
cast through every pixel of the ROI's ``crop``² window (its top-left at
the box's corner) gives the surface's depth, the model-frame xyz and the
hit mask. The frames' depth is a tilted background plane with every ROI
z-buffered into it, so ROIs of one frame occlude each other; the visible
mask is where a ROI is the nearest surface. RGB is uniform noise with
each object painted in its class colour. A pool of ``pool`` slots holds
``frames`` frames and ``rois`` ROIs each; ROI j of a slot lies in frame
j % frames.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

CAMERAS = {
    # LineMOD's Kinect (BOP lm camera.json)
    "lm": (572.4114, 573.57043, 325.2611, 242.04899),
    # YCB-Video's Asus Xtion (BOP ycbv camera_uw.json)
    "ycbv": (1066.778, 1067.487, 312.9869, 241.3109),
}


@dataclass
class Classes:
    extents: torch.Tensor     # [C, 3]
    points: torch.Tensor      # [C, N, 3]
    fps: torch.Tensor         # [C, K, 3]
    sym_rots: torch.Tensor    # [C, S, 3, 3] identity-padded
    colors: torch.Tensor      # [C, 3] uint8


def _farthest_points(pts: torch.Tensor, k: int) -> torch.Tensor:
    """[C, N, 3] -> [C, k, 3]: farthest point sampling from point 0."""
    C, N, _ = pts.shape
    idx = torch.zeros(C, k, dtype=torch.long, device=pts.device)
    d = torch.full((C, N), float("inf"), device=pts.device)
    for i in range(1, k):
        last = pts[torch.arange(C, device=pts.device), idx[:, i - 1]]
        d = torch.minimum(d, (pts - last[:, None]).square().sum(-1))
        idx[:, i] = d.argmax(dim=1)
    return torch.gather(pts, 1, idx[..., None].expand(-1, -1, 3))


def _axis_rotations(axis: tuple[float, float, float], n: int) -> torch.Tensor:
    """Rotations by 2 pi i / n about ``axis``, i = 0 .. n-1: [n, 3, 3]."""
    a = torch.tensor(axis, dtype=torch.float64)
    a = a / a.norm()
    ang = torch.arange(n, dtype=torch.float64) * (2 * math.pi / n)
    c, s = ang.cos()[:, None, None], ang.sin()[:, None, None]
    k = torch.tensor([[0, -a[2], a[1]], [a[2], 0, -a[0]],
                      [-a[1], a[0], 0]], dtype=torch.float64)
    return (c * torch.eye(3, dtype=torch.float64) + s * k
            + (1 - c) * torch.outer(a, a)).float()


def symmetry_bank(spec: dict) -> torch.Tensor:
    """A class's rotation bank from its entry in the configuration's
    ``symmetries``: ``{"continuous": axis, "step": rad}`` (BOP's
    discretisation: ceil(pi / step) rotations) or ``{"discrete": [axis,
    ...]}`` (a 180-degree turn about each, with the identity first)."""
    if "continuous" in spec:
        return _axis_rotations(tuple(spec["continuous"]),
                               math.ceil(math.pi / spec["step"]))
    rots = [torch.eye(3)] + [_axis_rotations(tuple(ax), 2)[1]
                             for ax in spec["discrete"]]
    return torch.stack(rots)


def make_classes(num_classes: int, num_points: int, num_fps: int,
                 extent_range: tuple[float, float], symmetries: dict,
                 gen: torch.Generator, device: torch.device) -> Classes:
    lo, hi = extent_range
    ext = lo + (hi - lo) * torch.rand(num_classes, 3, generator=gen,
                                      device=device)
    # points on the box surface: a uniform point of the cube, pushed to
    # the face of its largest coordinate
    u = torch.rand(num_classes, num_points, 3, generator=gen,
                   device=device) * 2 - 1
    face = u.abs().argmax(dim=-1, keepdim=True)
    u = u.scatter(-1, face, torch.gather(u, -1, face).sign())
    pts = u * ext[:, None] / 2
    banks = [symmetry_bank(symmetries[str(c)]) if str(c) in symmetries
             else torch.eye(3)[None] for c in range(num_classes)]
    S = max(b.shape[0] for b in banks)
    sym = torch.eye(3).repeat(num_classes, S, 1, 1)
    for c, b in enumerate(banks):
        sym[c, :b.shape[0]] = b
    colors = torch.randint(40, 256, (num_classes, 3), generator=gen,
                           device=device, dtype=torch.uint8)
    return Classes(ext, pts, _farthest_points(pts, num_fps),
                   sym.to(device), colors)


def random_rotations(n: int, gen: torch.Generator,
                     device: torch.device) -> torch.Tensor:
    q = torch.randn(n, 4, generator=gen, device=device)
    w, x, y, z = (q / q.norm(dim=1, keepdim=True)).unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(n, 3, 3)


@dataclass
class Slot:
    """One pool slot: F frames and B ROIs, all on the device."""
    rgb: torch.Tensor          # [F, H, W, 3] uint8
    depth: torch.Tensor        # [F, H, W] float32 metres
    K: torch.Tensor            # [F, 3, 3]
    frame_idx: torch.Tensor    # [B] int64
    bbox: torch.Tensor         # [B, 4] xyxy of the visible pixels
    cls: torch.Tensor          # [B] int64
    rot: torch.Tensor          # [B, 3, 3]
    trans: torch.Tensor        # [B, 3]
    centroid_2d: torch.Tensor  # [B, 2]
    mask_packed: torch.Tensor  # [B, crop, crop] uint8: visib bit 0, trunc 1
    xyz: torch.Tensor          # [B, crop, crop, 3] float16 model frame
    xyz_offset: torch.Tensor   # [B, 2] the crop's top-left pixel


def render_slot(classes: Classes, n_frames: int, n_rois: int,
                hw: tuple[int, int], camera: str, z_range: tuple[float, float],
                crop: int, gen: torch.Generator,
                device: torch.device) -> Slot:
    H, W = hw
    fx, fy, cx, cy = CAMERAS[camera]
    K = torch.tensor([[fx, 0, cx], [0, fy, cy], [0, 0, 1]],
                     dtype=torch.float32, device=device)
    B, C = n_rois, classes.extents.shape[0]
    cls = torch.randint(0, C, (B,), generator=gen, device=device)
    R = random_rotations(B, gen, device)
    r = torch.rand(B, 3, generator=gen, device=device)
    z = z_range[0] + (z_range[1] - z_range[0]) * r[:, 0]
    u, v = r[:, 1] * (W - 1), r[:, 2] * (H - 1)
    t = torch.stack([(u - cx) * z / fx, (v - cy) * z / fy, z], dim=-1)
    half = classes.extents[cls] / 2
    # the projected box of the 8 corners sets the crop's top-left
    signs = torch.tensor([[a, b, c] for a in (-1, 1) for b in (-1, 1)
                          for c in (-1, 1)], dtype=torch.float32,
                         device=device)
    corners = (signs[None] * half[:, None]) @ R.transpose(1, 2) + t[:, None]
    pu = fx * corners[..., 0] / corners[..., 2] + cx
    pv = fy * corners[..., 1] / corners[..., 2] + cy
    x0 = torch.floor(pu.amin(1)).clamp(-crop // 2, W - crop // 2)
    y0 = torch.floor(pv.amin(1)).clamp(-crop // 2, H - crop // 2)
    g = torch.arange(crop, dtype=torch.float32, device=device)
    px = x0[:, None, None] + g[None, None, :]            # [B, 1, crop]
    py = y0[:, None, None] + g[None, :, None]            # [B, crop, 1]
    d = torch.stack(torch.broadcast_tensors(
        (px - cx) / fx, (py - cy) / fy, torch.ones_like(px * py)), dim=-1)
    Rt = R.transpose(1, 2)
    o = -(Rt @ t[..., None])[..., 0]                     # camera in model
    dm = torch.einsum("bij,bhwj->bhwi", Rt, d)
    inv = 1.0 / torch.where(dm.abs() < 1e-12, torch.full_like(dm, 1e-12),
                            dm)
    t1 = (-half[:, None, None] - o[:, None, None]) * inv
    t2 = (half[:, None, None] - o[:, None, None]) * inv
    tmin = torch.minimum(t1, t2).amax(-1)
    tmax = torch.maximum(t1, t2).amin(-1)
    inside = (px >= 0) & (px < W) & (py >= 0) & (py < H)
    hit = (tmax >= tmin) & (tmin > 0) & inside
    xyz = torch.where(hit[..., None], o[:, None, None] + tmin[..., None] * dm,
                      torch.zeros_like(dm))
    zhit = torch.where(hit, tmin, torch.full_like(tmin, float("inf")))

    fidx = torch.arange(B, device=device) % n_frames
    yy, xx = torch.meshgrid(torch.arange(H, device=device),
                            torch.arange(W, device=device), indexing="ij")
    depth = (1.5 + 0.4 * yy / H + 0.1 * xx / W).float().expand(
        n_frames, H, W).contiguous()
    lin = (fidx[:, None, None] * H + py.clamp(0, H - 1).long()) * W \
        + px.clamp(0, W - 1).long()
    flat = depth.view(-1)
    flat.scatter_reduce_(0, lin[hit], zhit[hit], reduce="amin")
    visib = hit & (zhit <= flat[lin] + 1e-6)
    rgb = torch.randint(0, 256, (n_frames, H, W, 3), generator=gen,
                        device=device, dtype=torch.uint8)
    rgb.view(-1, 3)[lin[visib]] = classes.colors[cls][:, None, None].expand(
        -1, crop, crop, -1)[visib]

    # the box of the visible pixels; of the whole surface where none is
    # visible; of the projected corners where the window shows none
    shown = torch.where(visib.flatten(1).any(1)[:, None, None], visib, hit)
    cols = shown.any(1)
    rows = shown.any(2)
    ar = torch.arange(crop, device=device)
    big = crop + 1

    def span(m):
        first = torch.where(m, ar, big).amin(1)
        last = torch.where(m, ar, -1).amax(1)
        return first, last

    (c0, c1), (r0, r1) = span(cols), span(rows)
    bbox = torch.stack([x0 + c0, y0 + r0, x0 + c1, y0 + r1], -1).float()
    corner_box = torch.stack([pu.amin(1), pv.amin(1), pu.amax(1),
                              pv.amax(1)], -1)
    corner_box = torch.minimum(corner_box.clamp_min(0), torch.tensor(
        [W - 1, H - 1, W - 1, H - 1], dtype=torch.float32, device=device))
    bbox = torch.where(shown.flatten(1).any(1)[:, None], bbox, corner_box)
    proj = t @ K.T
    packed = visib.to(torch.uint8) * 3
    return Slot(rgb, depth, K.expand(n_frames, 3, 3).contiguous(), fidx,
                bbox, cls, R, t, proj[:, :2] / proj[:, 2:], packed,
                xyz.half(), torch.stack([x0, y0], -1))


def full_frame_masks(slot: Slot, hw: tuple[int, int]) -> torch.Tensor:
    """The packed crops pasted into [B, H, W] frames: the form the labels
    from the depth surface take (the loader ships crops only with xyz)."""
    H, W = hw
    B, crop = slot.mask_packed.shape[:2]
    out = torch.zeros(B, H, W, dtype=torch.uint8,
                      device=slot.mask_packed.device)
    for b, (x0, y0) in enumerate(slot.xyz_offset.long().tolist()):
        xa, ya = max(x0, 0), max(y0, 0)
        xb, yb = min(x0 + crop, W), min(y0 + crop, H)
        if xb > xa and yb > ya:
            out[b, ya:yb, xa:xb] = slot.mask_packed[b, ya - y0:yb - y0,
                                                    xa - x0:xb - x0]
    return out


def rois_of(slot: Slot, classes: Classes, num_pm_points: int,
            ship_xyz: bool) -> dict[str, torch.Tensor]:
    """A train step's per-ROI tensors as the grouped path takes them."""
    c = slot.cls
    rois = {"frame_idx": slot.frame_idx, "bbox": slot.bbox,
            "fps": classes.fps[c], "extent": classes.extents[c],
            "roi_cls": c, "gt_rot": slot.rot, "gt_trans": slot.trans,
            "centroid_2d": slot.centroid_2d,
            "mask_packed": slot.mask_packed,
            "roi_points": classes.points[c, :num_pm_points],
            "sym_rots": classes.sym_rots[c]}
    if ship_xyz:
        rois.update(xyz=slot.xyz, xyz_offset=slot.xyz_offset)
    return rois
