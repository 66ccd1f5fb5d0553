"""The reference's configuration: a frozen copy of the schema, defaults
and ``apply_opts`` rules of ``rdpn6d_tpu_torch/config.py``, so the
benchmark's opts give the reference the program's settings without
importing it.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class BackboneConfig:
    depth: int = 34                 # 18/34/50/101/152
    input_res: int = 256
    rgb_channels: int = 3           # trunk consumes RGB; depth-XYZ feeds fusion
    freeze: bool = False
    rot_concat: bool = False        # multi-scale skip fusion into the head
    pretrained: str = ""            # path to a converted torchvision npz, or ""
    space_to_depth: bool = False    # s2d(2)+4x4/s1 stem rewrite


@dataclass(frozen=True)
class HeadConfig:
    num_filters: int = 256
    num_layers: int = 3
    out_res: int = 64
    norm: str = "BN"                # BN | GN
    gn_groups: int = 32
    num_classes: int = 13
    num_regions: int = 32
    coord_residual: bool = True     # rotated FPS-residual coords; False =
    # GDR-Net absolute normalized coords
    xyz_loss: str = "L1"            # L1 | CE_coor
    xyz_bin: int = 64
    xyz_loss_mask: str = "visib"    # trunc | visib | obj
    xyz_lw: float = 1.0
    mask_loss: str = "L1"           # L1 | BCE | CE
    mask_loss_gt: str = "trunc"
    mask_lw: float = 1.0
    mask_thr_test: float = 0.5
    region_loss_mask: str = "visib"
    region_lw: float = 1.0
    rot_class_aware: bool = False
    mask_class_aware: bool = False
    region_class_aware: bool = False
    # weight init of the dense head and the PnP net: "reference" = tiny
    # normal(std=0.001) everywhere; "fan_in" = lecun normal
    init: str = "reference"         # reference | fan_in

    @property
    def coord_dim(self) -> int:
        return 3 * (self.xyz_bin + 1) if self.xyz_loss == "CE_coor" else 3

    @property
    def mask_dim(self) -> int:
        return 2 if self.mask_loss == "CE" else 1

    @property
    def region_dim(self) -> int:
        return self.num_regions + 1


@dataclass(frozen=True)
class PnPConfig:
    featdim: int = 128
    num_layers: int = 3
    norm: str = "GN"
    gn_groups: int = 32
    drop_prob: float = 0.0
    rot_type: str = "allo_rot6d"    # {allo,ego}_{rot6d,quat}
    trans_type: str = "centroid_z"
    z_type: str = "REL"
    with_2d_coord: bool = True      # concat [depth_xyz/4 ; 2d coords] (5 ch)
    region_attention: bool = True
    mask_attention: str = "mul"     # none | mul | concat
    pnp_head: str = "ConvPnPNet"    # ConvPnPNet | SimplePointPnP | PointPnP
    r_only: bool = False            # translation from TransHead instead

    @property
    def rot_dim(self) -> int:
        if "rot6d" in self.rot_type:
            return 6
        if "lie_vec" in self.rot_type:
            return 3
        return 4  # quat / log_quat

    @property
    def is_allo(self) -> bool:
        return self.rot_type.startswith("allo")


@dataclass(frozen=True)
class LossConfig:
    pm_lw: float = 1.0
    pm_loss_type: str = "L1"
    pm_norm_by_extent: bool = True
    pm_r_only: bool = True
    pm_loss_sym: bool = False
    pm_smooth_l1_beta: float = 1.0
    pm_disentangle_t: bool = False
    pm_disentangle_z: bool = False
    pm_t_use_points: bool = False
    num_pm_points: int = 3000
    centroid_loss: str = "L1"
    centroid_lw: float = 1.0
    z_loss: str = "L1"
    z_lw: float = 1.0
    rot_lw: float = 0.0
    rot_loss_type: str = "angular"
    trans_lw: float = 0.0
    trans_loss_disentangle: bool = True
    bind_lw: float = 0.0
    use_mtl: bool = False


@dataclass(frozen=True)
class DataConfig:
    dzi_type: str = "uniform"       # uniform | roi10d | none
    dzi_pad_scale: float = 1.5
    dzi_scale_ratio: float = 0.25
    dzi_shift_ratio: float = 0.25
    input_res: int = 256
    out_res: int = 64
    pixel_mean: tuple[float, float, float] = (0.0, 0.0, 0.0)
    pixel_std: tuple[float, float, float] = (255.0, 255.0, 255.0)
    color_aug_prob: float = 0.0
    color_aug_type: str = "aae"     # code | aae | aae_weak | lm | roi10d | none
    color_aug_ops: tuple = ()
    change_bg_prob: float = 0.0
    bg_images_dir: str = ""
    truncate_fg: bool = False
    filter_visib_thr: float = 0.0
    repeat_factor_thresh: float = 0.0
    grouped_train: bool = True
    frame_bucket: int = 8
    fused_train_step: bool = False
    ship_crops: bool = True
    crop_pad: int = 64
    frame_cache_mb: int = 2048
    device_frame_cache_mb: int = 1024
    train_datasets: tuple[str, ...] = ()
    train2_datasets: tuple[str, ...] = ()
    train2_ratio: float = 0.0
    test_datasets: tuple[str, ...] = ()
    det_files_test: tuple[str, ...] = ()
    det_topk_per_obj: int = 100


@dataclass(frozen=True)
class SolverConfig:
    ims_per_batch: int = 24
    total_epochs: int = 25
    optimizer: str = "ranger"
    base_lr: float = 1e-4
    weight_decay: float = 0.0
    lr_scheduler: str = "flat_and_anneal"
    anneal_method: str = "cosine"
    anneal_point: float = 0.72
    warmup_iters: int = 1000
    warmup_factor: float = 0.001
    max_grad_norm: float = 0.0      # 0 = off
    host_lr: bool = False
    amp: bool = True                # bf16 compute
    remat: bool = False


@dataclass(frozen=True)
class TrainRuntimeConfig:
    checkpoint_period_epochs: float = 5.0
    max_to_keep: int = 5
    log_period: int = 100
    eval_period: int = 0
    seed: int = 0
    output_dir: str = "output"
    tb_histograms: bool = False
    nan_guard_period: int = 1


@dataclass(frozen=True)
class TestConfig:
    use_pnp: bool = False
    pnp_type: str = "ransac_kabsch"  # ransac_kabsch | net
    test_bbox_type: str = "gt"       # gt | est
    error_types: str = "ad,adi,AUCad,re,te,proj"
    eval_precision: bool = False
    plots: bool = True
    int8_static: Any = False         # False | True | "per_channel"
    int8: str = ""                   # "" | head | trunk | all


@dataclass(frozen=True)
class Config:
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    head: HeadConfig = field(default_factory=HeadConfig)
    pnp: PnPConfig = field(default_factory=PnPConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    data: DataConfig = field(default_factory=DataConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    train: TrainRuntimeConfig = field(default_factory=TrainRuntimeConfig)
    test: TestConfig = field(default_factory=TestConfig)
    exp_name: str = "rdpn6d"

    def apply_opts(self, opts: list[str]) -> "Config":
        """Dotted overrides: ``solver.base_lr=3e-4 head.num_regions=16``.

        Values parse as JSON; the bare words ``True``/``False`` become
        bools (a fall-through string "False" would be truthy), and lists
        become tuples so configs stay hashable."""
        cfg = self
        for opt in opts:
            key, sep, raw = opt.partition("=")
            if not sep:
                raise ValueError(f"malformed opt {opt!r}: expected "
                                 "section.key=value")
            parts = key.strip().split(".")
            try:
                value = json.loads(raw)
            except json.JSONDecodeError:
                value = raw
                if value in ("True", "False"):
                    value = value == "True"
            if isinstance(value, list):
                value = tuple(value)
            if len(parts) == 1:
                cfg = dataclasses.replace(cfg, **{parts[0]: value})
            elif len(parts) == 2:
                section = dataclasses.replace(
                    getattr(cfg, parts[0]), **{parts[1]: value})
                cfg = dataclasses.replace(cfg, **{parts[0]: section})
            else:
                raise ValueError(f"opt key too deep: {key}")
        return cfg

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)
