"""Serving: the eval runner's path over resident frames.

Each item is a batch of ``rois`` detections over ``frames`` frames:
``data/pipeline.preprocess_rois_grouped(train=False)`` then
``parallel.make_eval_step(cfg, model)`` on the model cast to bfloat16
(int8 heads keep their float32 weights and calibrate their static scales
on one batch at set-up), as ``engine/eval_runner`` and
``engine/predictor`` build it. Batch i+1 is launched before batch i's
``rot_ego`` and ``trans`` are read back, as
``engine/inference.inference_on_dataset`` does. Batch i reads pool slot
i % pool; its boxes are the slot's, each moved by a detector's noise
drawn for that batch (``box_noise`` of the side), so no two batches are
the same input.

``correct``: a sample of the window's batches, drawn from the seed, runs
again through the reference (``port_bench/reference``: the crop and
back-projection, the trunk, the fusion, the dense head, ConvPnP and the
allo-to-ego pose, with the model cast to bfloat16 as the program serves
it; the int8 head emulated at 8 bits with its own calibration) on the same frames and boxes, and every pose is held to
it: the widest rotation angle, and the widest translation gap over the
larger of the reference's |t| and the sample's median |t|.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from port_bench.harness import context as hctx
from port_bench.harness.weights import seeded_state

KIND = "serve"
ANSWER = "poses"


def end_to_end(window, setup_s: float) -> dict[str, float]:
    """Poses read back a second over the whole window, and the 95th
    percentile of every batch's first call to its poses on the host."""
    from port_bench.harness.loop import p95_ms

    return {"poses_per_s": window.answers / window.seconds,
            "request_p95_ms": p95_ms(window), "setup_s": setup_s}


def flops_per_item(driver) -> float:
    """The reference's FLOPs of one served batch (the forward)."""
    from port_bench.harness import flops

    rcfg = driver.reference_config()
    return flops.count(rcfg, driver.ctx.cell["rois"], False,
                       rcfg.loss.num_pm_points,
                       driver.classes.sym_rots.shape[1])


class Driver:
    def __init__(self, ctx: hctx.Context):
        from rdpn6d_tpu_torch.config import Config
        from rdpn6d_tpu_torch.data.pipeline import preprocess_rois_grouped
        from rdpn6d_tpu_torch.models import RDPN
        from rdpn6d_tpu_torch.models.quant import calibrate_quant, serving_mode
        from rdpn6d_tpu_torch.parallel import make_eval_step

        self.ctx = ctx
        cell, dev = ctx.cell, ctx.device
        self.cfg = cfg = Config(exp_name=cell["config"]).apply_opts(ctx.opts)
        int8, static = serving_mode(cfg)
        self.int8 = bool(int8)
        model = RDPN(cfg, int8=int8, int8_static=static)
        self.weights = seeded_state(model, ctx.seed * 16 + hctx.WEIGHTS,
                                    dev, ctx.config.get("seeded_biases"))
        model.load_state_dict(self.weights)
        self.model = model.to(device=dev, dtype=torch.bfloat16).eval()
        self.classes, self.slots = hctx.make_pool(
            ctx, train=False, ship_xyz=False,
            num_points=cfg.loss.num_pm_points,
            num_fps=cfg.head.num_regions, num_classes=cfg.head.num_classes)
        self.boxes = self._detections(torch.randn(
            cell["noise_batches"], cell["rois"], 4,
            generator=ctx.generator(hctx.JITTER), device=dev)
            * cell["box_noise"])
        self.rois = [{"frame_idx": s.frame_idx,
                      "fps": self.classes.fps[s.cls],
                      "extent": self.classes.extents[s.cls],
                      "roi_cls": s.cls} for s in self.slots]
        self._pre = preprocess_rois_grouped
        self._eval = make_eval_step(cfg, self.model)
        if int8 and static:
            with torch.no_grad():
                calibrate_quant(self.model, [self._pre(
                    self.cfg, *self.inputs(-1))])
        self.poses: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    # -- inputs -------------------------------------------------------
    def _detections(self, noise: torch.Tensor) -> torch.Tensor:
        """Every batch's boxes [N, B, 4]: batch j's slot's boxes, each
        moved by ``noise[j]`` times its side, kept in the frame."""
        P = len(self.slots)
        box = torch.stack([self.slots[j % P].bbox
                           for j in range(noise.shape[0])])
        side = (box[..., 2:] - box[..., :2]).clamp_min(1.0).repeat(1, 1, 2)
        box = box + side * noise
        H, W = self.ctx.cell["frame_hw"]
        lim = torch.tensor([W - 1, H - 1, W - 1, H - 1], dtype=box.dtype,
                           device=box.device)
        box = torch.minimum(box.clamp_min(0), lim)
        lo = box[..., :2]
        return torch.cat([lo, torch.maximum(box[..., 2:], lo + 2.0)], -1)

    def inputs(self, i: int) -> tuple[dict, dict]:
        """Batch i's frames and detections, views of what set-up made;
        i = -1 is the calibration batch (slot 0's boxes as they are)."""
        P = len(self.slots)
        slot = self.slots[i % P] if i >= 0 else self.slots[0]
        box = self.boxes[i % self.boxes.shape[0]] if i >= 0 else slot.bbox
        frames = {"rgb": slot.rgb, "depth": slot.depth, "K": slot.K}
        return frames, dict(self.rois[i % P] if i >= 0 else self.rois[0],
                            bbox=box)

    # -- the window ---------------------------------------------------
    def launch(self, i: int):
        from torch.profiler import record_function

        frames, rois = self.inputs(i)
        with record_function("bench.preprocess"):
            batch = self._pre(self.cfg, frames, rois)
        with record_function("bench.model"):
            out = self._eval(batch)
        rot, trans = out["rot_ego"], out["trans"]
        if self.ctx.fault == "answer":
            rot = rot.clone()
            rot[0] = rot[0].T.contiguous()
        elif self.ctx.fault == "half_batch":
            n = rot.shape[0] // 2
            rot, trans = rot[:n], trans[:n]
        return rot, trans

    def collect(self, i: int, handle) -> tuple[int, bool]:
        from torch.profiler import record_function

        with record_function("bench.readback"):
            rot = handle[0].float().cpu().numpy()
            trans = handle[1].float().cpu().numpy()
        self.poses[i] = (rot, trans)
        ok = bool(np.isfinite(rot).all() and np.isfinite(trans).all())
        return rot.shape[0], ok

    def kernel_shapes(self, i: int) -> dict[str, list[dict]]:
        """The shapes of batch i's launches of the measured kernels."""
        frames, rois = self.inputs(i)
        cfg, d = self.cfg, self.cfg.data
        box = rois["bbox"]
        side = torch.maximum(box[:, 2] - box[:, 0], box[:, 3] - box[:, 1])
        H, W = frames["rgb"].shape[1:3]
        scale = (side * d.dzi_pad_scale).clamp(1.0, float(max(H, W)))
        center = (box[:, :2] + box[:, 2:]) / 2
        out = {"roi_crop": [{
            "S": d.input_res, "O": d.out_res, "H": H, "W": W,
            "F": frames["rgb"].shape[0], "rgb_bytes": 1, "depth_bytes": 4,
            "center": center.cpu(), "scale": scale.cpu(),
            "frame_idx": rois["frame_idx"].cpu()}]}
        if self.int8:
            B, n, o = box.shape[0], cfg.head.num_filters, d.out_res
            skip = 64 if cfg.backbone.rot_concat else 0
            out["int8_conv"] = [
                {"B": B, "H": o, "W": o, "C": n + (skip if j == 0 else 0),
                 "N": n, "k": 3, "stride": 1, "pad": 1}
                for j in range(2 * cfg.head.num_layers)]
        return out

    def release(self) -> None:
        del self.model, self._eval
        hctx.free_device()

    # -- correct ------------------------------------------------------
    def reference_config(self):
        from port_bench.reference.config import Config as RConfig

        return RConfig(exp_name=self.ctx.cell["config"]).apply_opts(
            self.ctx.opts)

    def sample(self, done: list[int]) -> list[int]:
        rng = np.random.default_rng(self.ctx.seed)
        k = min(self.ctx.cell["check_batches"], len(done))
        return sorted(rng.choice(done, size=k, replace=False).tolist())

    def reference_poses(self, indices: list[int], bits: int | None,
                        channels_last: bool = False
                        ) -> dict[int, tuple[torch.Tensor, torch.Tensor]]:
        """The reference's poses of batches ``indices``: the model cast to
        bfloat16 as the program serves it, with the head's convolutions
        emulated at ``bits`` where given. ``channels_last`` (readings
        only) keeps its weights in that layout, so cuDNN runs other kernels
        that sum in another order: a bf16 path as sound as the program's."""
        from port_bench.reference.data.pipeline import \
            preprocess_rois_grouped as rpre
        from port_bench.reference.models import RDPN as RModel
        from port_bench.reference.models.quant import calibrate
        from port_bench.reference.parallel.train_step import make_eval_step

        rcfg = self.reference_config()
        model = RModel(rcfg, int8_head=bits is not None, bits=bits or 8)
        model.load_state_dict(self.weights)
        model = model.to(device=self.ctx.device,
                         dtype=torch.bfloat16).eval()
        if channels_last:
            # cuDNN takes the layout of the weights: NHWC kernels
            model = model.to(memory_format=torch.channels_last)
        step = make_eval_step(rcfg, model)
        out = {}
        with hctx.full_float32(), torch.no_grad():
            if bits is not None:
                calibrate(model, rpre(rcfg, *self.inputs(-1)))
            for i in indices:
                o = step(rpre(rcfg, *self.inputs(i)))
                out[i] = (o["rot_ego"].float(), o["trans"].float())
        del model
        hctx.free_device()
        return out

    def compare(self, prog: dict, ref: dict) -> dict[str, float]:
        """The widest rotation angle (degrees) and translation gap over
        the poses of the batches in ``ref``."""
        rots, trans = [], []
        for i, (r_ref, t_ref) in ref.items():
            r_p, t_p = prog[i]
            r_p = torch.as_tensor(r_p, device=r_ref.device)
            t_p = torch.as_tensor(t_p, device=t_ref.device)
            if r_p.shape != r_ref.shape:   # answers missing
                return {"rot_gap_deg": math.inf, "trans_gap": math.inf}
            # the angle of R_p^T R_ref from ||R_p - R_ref||_F = 2 sqrt(2)
            # sin(angle / 2): no arccos near 1, which reads a rotation a
            # few 1e-5 off orthonormal as tenths of a degree
            fro = (r_p.double() - r_ref.double()).flatten(1).norm(dim=1)
            rots.append(torch.rad2deg(2 * torch.asin(
                (fro / (2 * math.sqrt(2))).clamp(max=1.0))))
            trans.append(((t_p - t_ref).norm(dim=1), t_ref.norm(dim=1)))
        gap = torch.cat([g for g, _ in trans])
        tnorm = torch.cat([n for _, n in trans])
        tg = (gap / torch.maximum(tnorm, tnorm.median())).nan_to_num(
            math.inf)
        rg = torch.cat(rots).nan_to_num(math.inf)
        return {"rot_gap_deg": float(rg.max()), "trans_gap": float(tg.max())}

    def check(self, window) -> dict[str, float]:
        done = list(range(window.start, window.start + window.items))
        ref = self.reference_poses(self.sample(done),
                                   self.ctx.cell.get("reference_bits"))
        return self.compare(self.poses, ref)

    # -- controls (readings only) -------------------------------------
    def variant_poses(self, indices: list[int]) -> dict:
        """The reference in channels_last on batches ``indices``: what a
        sound change of the served forward's summation order reads."""
        return {i: (r.cpu().numpy(), t.cpu().numpy()) for i, (r, t) in
                self.reference_poses(indices,
                                     self.ctx.cell.get("reference_bits"),
                                     channels_last=True).items()}

    def control_poses(self, indices: list[int]) -> dict:
        """The cell's control on batches ``indices``: its ``control``
        entry names either the program with opts added (a lower-precision
        path of its own) or the reference at fewer bits."""
        spec = self.ctx.cell["control"]
        if spec["kind"] == "reference":
            return {i: (r.cpu().numpy(), t.cpu().numpy()) for i, (r, t) in
                    self.reference_poses(indices, spec["bits"]).items()}
        ctx = hctx.Context(self.ctx.cell, self.ctx.config, self.ctx.seed,
                           self.ctx.device,
                           self.ctx.extra_opts + spec["opts"])
        ctl = Driver(ctx)
        out = {}
        for i in indices:
            ctl.collect(i, ctl.launch(i))
            out[i] = ctl.poses[i]
        ctl.release()
        return out
