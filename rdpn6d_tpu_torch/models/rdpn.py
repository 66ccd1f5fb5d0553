"""RDPN top module: backbone -> fusion -> dense head -> Patch-PnP -> pose.

Counterpart of ``rdpn6d_tpu/models/rdpn.py:RDPN``.
Submodules carry the reference checkpoint's names (``backbone.*``,
``backbone.spatial_net.*``, ``rot_head_net.features.*``, ``pnp_net.*``,
``trans_head_net.*``), so ``state_dict()`` has the reference layout;
``loss.use_mtl`` adds the ``log_var_*`` parameters at the top. Variants:
``backbone.space_to_depth`` (the exact s2d stem), ``pnp.pnp_head``
"ConvPnPNet", "SimplePointPnP" or "PointPnP" (``models/point_pnp.py``;
a point head takes the concatenated mask as one more channel), and
``pnp.r_only`` (the translation from ``TransHead`` on the trunk's 8x8
feature). The forward takes and returns the JAX
package's layout (channels last); inside, the network runs NCHW in the
parameters' dtype (or under the caller's autocast), with logits, the PnP
outputs and the pose recovery in float32. ``train()`` mode is the JAX
package's ``train=True``: batch-statistics BatchNorm and DropBlock.
``solver.remat`` checkpoints the trunk and the dense head in train mode
(``torch.utils.checkpoint``, non-reentrant), the two modules the JAX
package wraps in ``nn.remat``: their activations are recomputed in the
backward pass instead of kept, under the caller's autocast, and BatchNorm
moves its running statistics once (``models/norm.recomputing``). The
parameters and ``state_dict`` keys do not change; eval mode ignores it.
``int8`` (False | "" | True | "all" | "head" | "trunk" | "trunk0".."trunk3")
and ``int8_static`` (False | True | "per_channel") build the W8A8 serving
model of ``models/quant.py`` with the same parameters: the head's body
convs and/or the trunk's block convs (all stages, or one) become
``Int8Conv``; the stem, the fusion net, the head's output conv and the PnP
net stay in the model's dtype.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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
from .norm import recomputing
from .point_pnp import PointPnP, SimplePointPnP
from .pointnet import SpatialPointNet
from .quant import int8_targets
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
    if pnp.pnp_head == "SimplePointPnP":
        return SimplePointPnP(pnp_in_channels(cfg), rot_dim=pnp.rot_dim)
    if pnp.pnp_head == "PointPnP":
        return PointPnP(pnp_in_channels(cfg), rot_dim=pnp.rot_dim,
                        num_regions=cfg.head.num_regions)
    raise ValueError(pnp.pnp_head)


class RDPN(nn.Module):
    def __init__(self, cfg: Config, int8: Any = False,
                 int8_static: Any = False):
        super().__init__()
        h, pnp = cfg.head, cfg.pnp
        trunk_stages, int8_head = int8_targets(int8)
        self.cfg = cfg
        self.backbone = ResNetTrunk(cfg.backbone.depth, trunk_stages,
                                    int8_static,
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
            int8_static=int8_static)
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

        # solver.remat: the trunk and the dense head only. DropBlock, the
        # one random op, lies in ConvPnPNet outside them: it draws from an
        # explicit generator, whose state checkpoint would not restore. So
        # the checkpoint saves no RNG state (``_call``)
        remat = cfg.solver.remat and self.training
        skip64 = skip32 = None
        if cfg.backbone.rot_concat:
            feat, skips = _call(remat, self.backbone, rgb, return_skips=True)
            skip64, skip32 = skips[0], skips[1]
        else:
            feat = _call(remat, self.backbone, rgb)
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
        mask_logits, coord_out, region_logits = _call(
            remat, self.rot_head_net, fused, skip64)        # float32 NCHW

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

        # float32 even under autocast, which would take the 3x3 products
        # to bf16
        with torch.autocast(rot_m.device.type, enabled=False):
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


def _call(remat: bool, module: nn.Module, *args, **kwargs):
    """``module(*args, **kwargs)``, checkpointed where ``remat``."""
    if not remat:
        return module(*args, **kwargs)
    return checkpoint(module, *args, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          recomputing()), **kwargs)


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


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   g: torch.Generator) -> None:
    # flax lecun_normal: truncated (±2σ) normal of variance 1/fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)


def init_weights(model: RDPN, generator: torch.Generator) -> RDPN:
    """The port's seeded init, distributed as the JAX package's: lecun
    normal in the trunk and the fusion net; in the head, TransHead and the
    conv PnP net normal(0.001) ("reference") or lecun normal ("fan_in"), in
    a point PnP head lecun normal, with fc_r and fc_t at normal(0.01); zero
    biases, identity norms."""
    g = generator
    reference = model.cfg.head.init == "reference"
    # the point heads' layers take flax's default init whatever head.init
    conv_pnp = model.cfg.pnp.pnp_head == "ConvPnPNet"

    def small(w, fan_in):
        if reference:
            nn.init.normal_(w, 0.0, 0.001, generator=g)
        else:
            _lecun_normal_(w, fan_in, g)

    def fan_in_of(m):
        k = m.kernel_size[0] * m.kernel_size[1] \
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)) else 1
        return m.in_channels * k if not isinstance(m, nn.Linear) \
            else m.in_features

    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, (nn.BatchNorm2d, nn.GroupNorm)):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
                if isinstance(m, nn.BatchNorm2d):
                    m.reset_running_stats()
                continue
            if not isinstance(m, (nn.Conv2d, nn.ConvTranspose2d,
                                  nn.Linear)):
                continue
            if name in ("pnp_net.fc_r", "pnp_net.fc_t"):
                nn.init.normal_(m.weight, 0.0, 0.01, generator=g)
            elif name.startswith(("rot_head_net.", "trans_head_net.")) \
                    or name.startswith("pnp_net.") and conv_pnp:
                small(m.weight, fan_in_of(m))
            else:
                _lecun_normal_(m.weight, fan_in_of(m), g)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    return model
