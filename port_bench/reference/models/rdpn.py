"""RDPN top module of the reference: backbone -> fusion -> dense head ->
Patch-PnP -> pose.

A frozen copy of ``rdpn6d_tpu_torch/models/rdpn.py`` with the
reference checkpoint's names (``backbone.*``, ``backbone.spatial_net.*``,
``rot_head_net.features.*``, ``pnp_net.*``), so the benchmark hands both
sides one state dict. Departures: ConvPnPNet only, no remat, and the
quantized head is ``models/quant.py``'s ``bits``-bit emulation
(``int8_head``). The forward takes and returns the channels-last layout,
with logits, the PnP outputs and the pose recovery in float32.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch import nn

from ..config import Config
from ..geometry import (
    exp_map,
    ortho6d_to_mat,
    quat_to_mat,
    recover_pose_centroid_z,
)
from ..ops.binning import expected_coord_from_bins
from ..ops.region import gather_region_fps
from ..ops.resize import (
    downsample_nearest_torch,
    upsample_bilinear_align_corners,
)
from .conv_pnp import ConvPnPNet
from .heads import DenseHead, TransHead
from .pointnet import SpatialPointNet
from .resnet import ResNetTrunk


MTL_LOSSES = ("mask", "coor_x", "coor_y", "coor_z", "region")


def head_out_res(cfg: Config) -> int:
    """Side of the dense head's maps: trunk /32, ×4 upsample, ×2 convT,
    ×2 per layer past the third."""
    return cfg.backbone.input_res // 32 * 8 * 2 ** max(
        0, cfg.head.num_layers - 3)


def pnp_in_channels(cfg: Config) -> int:
    """Input channels of the PnP head: coord, 2-D coord, region FPS, the
    region softmax (not PointPnP's: it pools with it) and the mask."""
    pnp = cfg.pnp
    n = 3 + (5 if pnp.with_2d_coord else 0) + 3
    if pnp.region_attention and pnp.pnp_head != "PointPnP":
        n += cfg.head.num_regions
    n += 1 if pnp.mask_attention == "concat" else 0
    return n


def build_pnp_net(cfg: Config) -> nn.Module:
    pnp = cfg.pnp
    if pnp.pnp_head == "ConvPnPNet":
        return ConvPnPNet(
            pnp_in_channels(cfg), rot_dim=pnp.rot_dim, featdim=pnp.featdim,
            num_layers=pnp.num_layers, gn_groups=pnp.gn_groups,
            norm=pnp.norm, in_res=head_out_res(cfg),
            drop_prob=pnp.drop_prob)
    raise ValueError(pnp.pnp_head)


class RDPN(nn.Module):
    def __init__(self, cfg: Config, int8_head: bool = False,
                 bits: int = 8):
        super().__init__()
        h, pnp = cfg.head, cfg.pnp
        self.cfg = cfg
        self.backbone = ResNetTrunk(cfg.backbone.depth,
                                    s2d_stem=cfg.backbone.space_to_depth)
        ch = self.backbone.stage_channels
        # the reference keeps the fusion net inside the backbone module
        # (its state_dict keys are backbone.spatial_net.*)
        self.backbone.add_module("spatial_net", SpatialPointNet(ch[-1]))
        concat = cfg.backbone.rot_concat
        nc = h.num_classes
        self.rot_head_net = DenseHead(
            in_channels=self.backbone.spatial_net.out_channels
            + (ch[1] if concat else 0),
            mask_dim=h.mask_dim * (nc if h.mask_class_aware else 1),
            coord_dim=h.coord_dim * (nc if h.rot_class_aware else 1),
            region_dim=h.region_dim * (nc if h.region_class_aware else 1),
            num_filters=h.num_filters, num_layers=h.num_layers,
            norm=h.norm, gn_groups=h.gn_groups,
            skip_channels=ch[0] if concat else 0, int8=int8_head,
            bits=bits)
        self.pnp_net = build_pnp_net(cfg)
        if pnp.r_only:
            self.trans_head_net = TransHead(
                ch[-1], num_filters=h.num_filters,
                in_res=cfg.backbone.input_res // 32)
        if cfg.loss.use_mtl:
            # uncertainty weights s_i = log sigma_i^2 (loss * exp(-s) + s)
            for name in MTL_LOSSES:
                self.register_parameter(f"log_var_{name}",
                                        nn.Parameter(torch.zeros(1)))

    @property
    def dtype(self) -> torch.dtype:
        return self.backbone.conv1.weight.dtype

    def forward(self, batch: dict[str, torch.Tensor],
                drop_scale: float = 1.0,
                generator: torch.Generator | None = None,
                drop_shard: tuple[int, int] = (0, 1)
                ) -> dict[str, torch.Tensor]:
        """batch: roi_img [B,S,S,6] (rgb + depth xyz), roi_coord_2d
        [B,O,O,5], fps [B,K,3], roi_extent [B,3], roi_cam [B,3,3],
        bbox_center [B,2], roi_wh [B,2], resize_ratio [B], roi_cls [B].
        ``drop_scale``, ``generator`` and ``drop_shard`` (rank, world)
        drive DropBlock in train mode."""
        cfg = self.cfg
        h, pnp = cfg.head, cfg.pnp
        img = batch["roi_img"].permute(0, 3, 1, 2)
        rgb = img[:, :3].to(self.dtype)
        depth_xyz = img[:, 3:6]

        skip64 = skip32 = None
        if cfg.backbone.rot_concat:
            feat, skips = self.backbone(rgb, return_skips=True)
            skip64, skip32 = skips[0], skips[1]
        else:
            feat = self.backbone(rgb)
        if cfg.backbone.freeze:   # the trunk takes no gradient
            feat = feat.detach()
            skip64 = None if skip64 is None else skip64.detach()
            skip32 = None if skip32 is None else skip32.detach()
        feat8 = feat   # the trunk's 8x8 feature, TransHead's input
        h8, w8 = feat.shape[2], feat.shape[3]
        feat = upsample_bilinear_align_corners(feat, h8 * 4, w8 * 4)
        xyz32 = downsample_nearest_torch(depth_xyz, h8 * 4,
                                         w8 * 4).to(self.dtype)
        fused = self.backbone.spatial_net(feat, xyz32)
        if skip32 is not None:
            fused = torch.cat([fused, skip32.to(fused.dtype)], dim=1)
        mask_logits, coord_out, region_logits = self.rot_head_net(
            fused, skip64)        # float32 NCHW

        def select_class(x, dim):
            B, _, H, W = x.shape
            xr = x.reshape(B, h.num_classes, dim, H, W)
            return xr[torch.arange(B, device=x.device),
                      batch["roi_cls"].long()]

        if h.rot_class_aware:
            coord_out = select_class(coord_out, h.coord_dim)
        if h.mask_class_aware:
            mask_logits = select_class(mask_logits, h.mask_dim)
        if h.region_class_aware:
            region_logits = select_class(region_logits, h.region_dim)

        if h.xyz_loss == "CE_coor":
            nb = h.xyz_bin
            coord3 = torch.stack([
                expected_coord_from_bins(
                    coord_out[:, a * (nb + 1):(a + 1) * (nb + 1)]
                    .permute(0, 2, 3, 1), nb) for a in range(3)], dim=1)
        else:
            coord3 = coord_out
        feats = [coord3]
        if pnp.with_2d_coord:
            feats.append(batch["roi_coord_2d"].permute(0, 3, 1, 2))
        region_ids = region_logits[:, 1:].argmax(dim=1)      # [B,H,W]
        region_fps = gather_region_fps(batch["fps"], region_ids)
        feats.append(region_fps.permute(0, 3, 1, 2))
        coord_feat = torch.cat(feats, dim=1)

        mask_atten = mask_concat = None
        if pnp.mask_attention == "mul":
            mask_atten = mask_prob(mask_logits, h.mask_loss)
        elif pnp.mask_attention == "concat":
            mask_concat = mask_prob(mask_logits, h.mask_loss)
        region_atten = torch.softmax(region_logits[:, 1:], dim=1) \
            if pnp.region_attention else None
        if pnp.pnp_head == "ConvPnPNet":
            rot_param, t_param = self.pnp_net(
                coord_feat, region=region_atten,
                extents=batch["roi_extent"], mask_attention=mask_atten,
                mask_concat=mask_concat, drop_scale=drop_scale,
                generator=generator, drop_shard=drop_shard)
        else:
            if mask_concat is not None:   # no spatial slot: one channel
                coord_feat = torch.cat([coord_feat, mask_concat], dim=1)
            rot_param, t_param = self.pnp_net(
                coord_feat, region=region_atten,
                extents=batch["roi_extent"], mask_attention=mask_atten)
        if pnp.r_only:
            t_param = self.trans_head_net(feat8)

        if "rot6d" in pnp.rot_type:
            rot_m = ortho6d_to_mat(rot_param)
        elif "log_quat" in pnp.rot_type:
            v = rot_param[:, 1:4]
            n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
            q = torch.cat([torch.cos(n), v * torch.sinc(n / math.pi)], -1)
            rot_m = quat_to_mat(torch.exp(rot_param[:, :1]) * q)
        elif "lie_vec" in pnp.rot_type:
            rot_m = exp_map(rot_param[:, :3])
        else:
            rot_m = quat_to_mat(rot_param)

        # float32 even under a caller's autocast (not on the meta device,
        # which has none)
        dev = rot_m.device.type
        with torch.autocast(dev, enabled=False) if dev != "meta" \
                else contextlib.nullcontext():
            rot_ego, trans = recover_pose_centroid_z(
                rot_m, centroid_rel=t_param[:, :2], z_rel=t_param[:, 2],
                K=batch["roi_cam"], bbox_center=batch["bbox_center"],
                bbox_wh=batch["roi_wh"], resize_ratio=batch["resize_ratio"],
                z_type=pnp.z_type, is_allo=pnp.is_allo)

        def nhwc(x):
            return x.permute(0, 2, 3, 1)

        extra = {f"log_var_{n}": getattr(self, f"log_var_{n}")[0]
                 for n in MTL_LOSSES} if cfg.loss.use_mtl else {}
        return {
            **extra,
            "mask_logits": nhwc(mask_logits),
            "coord": nhwc(coord3),
            "coord_out": nhwc(coord_out),
            "region_logits": nhwc(region_logits),
            "rot_param": rot_param,
            "rot_mat": rot_m,
            "centroid_rel": t_param[:, :2],
            "z_rel": t_param[:, 2],
            "rot_ego": rot_ego,
            "trans": trans,
        }


def mask_prob(mask_logits: torch.Tensor, mask_loss: str) -> torch.Tensor:
    """Visibility probability map [B, 1, H, W] from the head's mask logits
    [B, Dm, H, W]; L1 is a per-sample min-max normalization."""
    if mask_loss == "L1":
        m = mask_logits[:, :1]
        mn = m.amin(dim=(1, 2, 3), keepdim=True)
        mx = m.amax(dim=(1, 2, 3), keepdim=True)
        return (m - mn) / (mx - mn).clamp_min(1e-12)
    if mask_loss == "BCE":
        return torch.sigmoid(mask_logits[:, :1])
    if mask_loss == "CE":
        return torch.softmax(mask_logits, dim=1)[:, 1:2]
    raise ValueError(mask_loss)
