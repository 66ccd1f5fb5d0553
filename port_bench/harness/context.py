"""What a driver is handed: the cell, its configuration, the seed and the
device; and the pieces the two drivers share."""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch

from . import scene


@dataclass
class Context:
    cell: dict                   # the workload file with name and chips
    config: dict                 # the configuration file
    seed: int
    device: torch.device
    extra_opts: list = field(default_factory=list)   # tests: tiny widths
    fault: str | None = None     # tests and readings: a broken timed path

    @property
    def opts(self) -> list[str]:
        return list(self.config["opts"]) + list(self.cell.get("opts", [])) \
            + list(self.extra_opts)

    def generator(self, purpose: int) -> torch.Generator:
        """The seed's generator for one purpose (weights, scene, draws)."""
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed * 16 + purpose)
        return g


WEIGHTS, SCENE, DRAWS, JITTER = range(4)


def make_pool(ctx: Context, train: bool, ship_xyz: bool,
              num_points: int, num_fps: int, num_classes: int):
    """The classes and the pool's slots of the cell's scene."""
    cfg, cell = ctx.config, ctx.cell
    gen = ctx.generator(SCENE)
    classes = scene.make_classes(
        num_classes, num_points, num_fps, tuple(cfg["extent_range"]),
        cfg.get("symmetries", {}), gen, ctx.device)
    slots = []
    for _ in range(cell["pool"]):
        s = scene.render_slot(classes, cell["frames"], cell["rois"],
                              tuple(cell["frame_hw"]), cfg["camera"],
                              tuple(cell["z_range"]), cell["crop"], gen,
                              ctx.device)
        if train and not ship_xyz:
            s.mask_packed = scene.full_frame_masks(s,
                                                   tuple(cell["frame_hw"]))
            s.xyz = None
        slots.append(s)
    return classes, slots


@contextlib.contextmanager
def full_float32():
    """TF32 off for the reference's convolutions and products."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def free_device() -> None:
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def rel_gap(prog: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """|prog - ref| of per-leaf (or per-ROI) norms over max(ref, the
    median ref): the measure of a leaf whose reference norm is near 0
    falls back to the median leaf's."""
    floor = ref.median()
    return (prog - ref).abs() / torch.maximum(ref, floor)
