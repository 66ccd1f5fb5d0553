"""Training: the trainer's step over resident frames.

Each item is one step of ``rois`` ROIs over ``frames`` frames:
``data/pipeline.preprocess_rois_grouped(train=True)`` then
``parallel.make_train_step`` (bf16 autocast, Ranger, flat_and_anneal),
as ``engine/trainer.Trainer.train`` runs it once the device frame cache
holds every frame; step i's metrics are read back after step i+1 is
launched, as the trainer's lag-1 NaN guard reads them. Step i reads pool
slot i % pool (raw frames with their raw depth, per-ROI packed masks,
poses, assets and, where the configuration ships them, xyz crops) with
the DZI boxes and colour-aug draws of row i of tables drawn from the
seed at set-up and handed to the program (``center_scale``,
``aug_params``). The state starts at iteration ``start_step``, past the
schedule's warm-up, with a fresh optimizer, as a run's steady state.

``correct``: set-up drives this same state through its first
``checked_steps`` steps by the window's own call, on different slots and
draws, and keeps each step's loss, the first gradient as Ranger got it
(its ``exp_avg`` after one step over 1 - b1) and the parameters' change
after the last. Seven steps take Ranger through both of its branches as
the window runs them: the plain momentum steps (t = 1..5), the rectified
adaptive step over the second moment with eps (t = 6, 7), and
Lookahead's sync (t = 6, k = 6). The reference (``port_bench/reference``:
the crop, the labels, the colour augmentation, the model, the losses,
the backward and Ranger, under bfloat16 autocast as the configuration
states) takes the same weights, frames and draws through the same steps.
Compared: the worst step's loss gap; by the worst leaf the gap of the
first gradient's norm and of the change's norm, each over the larger of
the reference's norm of that leaf and of the median leaf; and the median
leaf's change gap. Leaves whose reference gradient is under 1e-3 of the
median leaf's move by rounding alone and are left out of the change.
"""

from __future__ import annotations

import math

import torch

from port_bench.harness import context as hctx
from port_bench.harness.weights import seeded_state

KIND = "train"
ANSWER = "rois"



def end_to_end(window, setup_s: float) -> dict[str, float]:
    """ROIs of the steps read back a second over the whole window."""
    return {"train_rois_per_s": window.answers / window.seconds,
            "setup_s": setup_s}


def flops_per_item(driver) -> float:
    """The reference's FLOPs of one step (forward, losses, backward)."""
    from port_bench.harness import flops
    from port_bench.reference.config import Config as RConfig

    rcfg = RConfig(exp_name=driver.ctx.cell["config"]).apply_opts(
        driver.ctx.opts)
    return flops.count(rcfg, driver.ctx.cell["rois"], True,
                       rcfg.loss.num_pm_points,
                       driver.classes.sym_rots.shape[1])


# readings only: Ranger's hyperparameters set wrong in the program's own
# optimizer, to show what the compared numbers catch of the t >= 6 branch
OPTIMIZER_FAULTS = {"lookahead": {"alpha": 1.0},
                    "rectify": {"n_sma_threshold": 1e9},
                    "eps": {"eps": 1e-8}}


class Driver:
    def __init__(self, ctx: hctx.Context):
        from rdpn6d_tpu_torch.config import Config
        from rdpn6d_tpu_torch.data.pipeline import preprocess_rois_grouped
        from rdpn6d_tpu_torch.models import RDPN
        from rdpn6d_tpu_torch.parallel import (create_train_state,
                                               make_train_step)
        from rdpn6d_tpu_torch.solver import build_schedule

        self.ctx = ctx
        cell, dev = ctx.cell, ctx.device
        self.cfg = cfg = Config(exp_name=cell["config"]).apply_opts(ctx.opts)
        model = RDPN(cfg)
        self.weights = seeded_state(model, ctx.seed * 16 + hctx.WEIGHTS,
                                    dev, ctx.config.get("seeded_biases"))
        model.load_state_dict(self.weights)
        model = model.to(dev)
        self.ship_xyz = bool(cell["ship_xyz"])
        self.classes, self.slots = hctx.make_pool(
            ctx, train=True, ship_xyz=self.ship_xyz,
            num_points=cfg.loss.num_pm_points,
            num_fps=cfg.head.num_regions, num_classes=cfg.head.num_classes)
        for s in self.slots:
            s.depth_raw = torch.round(s.depth * cell["depth_factor"]).to(
                torch.int32)
            s.depth = None
        self.factor = torch.full((cell["frames"],),
                                 float(cell["depth_factor"]), device=dev)
        from port_bench.harness.scene import rois_of

        self.rois = [rois_of(s, self.classes, cfg.loss.num_pm_points,
                             self.ship_xyz)
                     for s in self.slots]
        self._draw_tables()
        self.schedule = build_schedule(cfg, cell["total_iters"])
        self.state = create_train_state(
            cfg, model, lr=self.schedule(cell["start_step"]))
        self.state.step = cell["start_step"]
        for group in self.state.optimizer.param_groups:
            group.update(OPTIMIZER_FAULTS.get(ctx.fault, {}))
        self._pre = preprocess_rois_grouped
        self._step = make_train_step(cfg, self.schedule)
        self.program = self._checked_steps()

    # -- inputs -------------------------------------------------------
    def _draw_tables(self) -> None:
        """Every step's DZI boxes and colour-aug draws, in bulk."""
        from port_bench.reference.data.augment import (config_ops,
                                                       draw_color_aug)
        from port_bench.reference.data.pipeline import dzi_jitter

        cell, d = self.ctx.cell, self.cfg.data
        n, B, P = cell["draw_steps"], cell["rois"], cell["pool"]
        gen = self.ctx.generator(hctx.DRAWS)
        per = -(-n // P)
        center = torch.empty(n, B, 2, device=self.ctx.device)
        scale = torch.empty(n, B, device=self.ctx.device)
        for p, slot in enumerate(self.slots):
            c, s = dzi_jitter(slot.bbox.repeat(per, 1),
                              tuple(cell["frame_hw"]), d.dzi_type,
                              d.dzi_pad_scale, d.dzi_scale_ratio,
                              d.dzi_shift_ratio, enable=True, generator=gen)
            center[p::P] = c.view(per, B, 2)[:len(range(p, n, P))]
            scale[p::P] = s.view(per, B)[:len(range(p, n, P))]
        self.center, self.scale = center, scale
        ops = config_ops(d.color_aug_ops, d.color_aug_type) \
            if d.color_aug_prob > 0 else ()
        self.aug = draw_color_aug(ops, n * B, d.color_aug_prob, gen,
                                  (d.input_res, d.input_res),
                                  self.ctx.device) if ops else None

    def inputs(self, i: int) -> tuple[dict, dict, tuple, dict | None]:
        """Step i's frames, ROIs, DZI boxes and colour draws: views of
        what set-up made, so the window launches nothing of its own."""
        slot = self.slots[i % len(self.slots)]
        frames = {"rgb": slot.rgb, "depth_raw": slot.depth_raw,
                  "depth_factor": self.factor, "K": slot.K}
        rois = self.rois[i % len(self.slots)]
        j = i % self.center.shape[0]
        cs = (self.center[j], self.scale[j])
        aug = None
        if self.aug is not None:
            B = self.ctx.cell["rois"]
            sl = slice(j * B, (j + 1) * B)
            aug = {"apply": self.aug["apply"][sl],
                   "ops": [{k: v[sl] for k, v in op.items()}
                           for op in self.aug["ops"]]}
        return frames, rois, cs, aug

    # -- the window ---------------------------------------------------
    def launch(self, i: int):
        from torch.profiler import record_function

        frames, rois, cs, aug = self.inputs(i)
        with record_function("bench.preprocess"):
            batch = self._pre(self.cfg, frames, rois, train=True,
                              center_scale=cs, aug_params=aug)
        if self.ctx.fault == "half_batch":
            n = batch["roi_img"].shape[0] // 2
            batch = {k: v[:n] if torch.is_tensor(v) and v.dim() > 0
                     and v.shape[0] == 2 * n else v
                     for k, v in batch.items()}
        with record_function("bench.step"):
            if self.ctx.fault == "unchanged":
                with torch.no_grad(), torch.autocast(
                        self.ctx.device.type, dtype=torch.bfloat16):
                    out = self.state.model(batch)
                metrics = {"total_loss": out["trans"].float().sum() * 0}
            else:
                self.state, metrics = self._step(self.state, batch)
        if self.ctx.fault == "answer":
            metrics = dict(metrics, total_loss=metrics["total_loss"] * 1.5)
        return metrics

    def collect(self, i: int, handle) -> tuple[int, bool]:
        from torch.profiler import record_function

        with record_function("bench.readback"):
            total = float(handle["total_loss"])
        return self.ctx.cell["rois"], math.isfinite(total)

    def kernel_shapes(self, i: int) -> dict[str, list[dict]]:
        frames, rois, (center, scale), _ = self.inputs(i)
        d, B = self.cfg.data, self.ctx.cell["rois"]
        H, W = frames["rgb"].shape[1:3]
        label = {"B": B, "O": d.out_res, "K": self.cfg.head.num_regions}
        return {
            "roi_crop": [{
                "S": d.input_res, "O": d.out_res, "H": H, "W": W,
                "F": frames["rgb"].shape[0], "rgb_bytes": 1,
                "depth_bytes": 4, "center": center.cpu(),
                "scale": scale.cpu(), "frame_idx": rois["frame_idx"].cpu()}],
            "gt_labels" if self.ship_xyz else "surface_labels": [label],
        }

    # -- correct ------------------------------------------------------
    def _leaf_norms(self, tensors) -> torch.Tensor:
        return torch.stack([t.float().norm() for t in tensors])

    def _checked_steps(self) -> dict:
        """Drive the state through the checked steps by the window's own
        call; what ``check`` compares."""
        cell = self.ctx.cell
        n = cell["checked_steps"]
        model, opt = self.state.model, self.state.optimizer
        params = [p for _, p in model.named_parameters()]
        p0 = [p.detach().clone() for p in params]
        losses, grad = [], None
        for i in range(n):
            losses.append(float(self.launch(i)["total_loss"]))
            if i == 0:
                grad = self._first_grad(opt, params)
        change = self._leaf_norms([p.detach() - q for p, q in
                                   zip(params, p0)])
        del p0
        self.next_index = n
        return {"loss": losses, "grad": grad, "change": change}

    @staticmethod
    def _first_grad(opt, params) -> torch.Tensor:
        """Each leaf's gradient norm as Ranger got it: exp_avg after one
        step is (1 - b1) g."""
        b1 = opt.param_groups[0]["betas"][0]
        return torch.stack([
            opt.state[p]["exp_avg"].float().norm() / (1 - b1)
            if p in opt.state and "exp_avg" in opt.state[p]
            else torch.zeros((), device=p.device) for p in params])

    def release(self) -> None:
        del self.state, self._step
        hctx.free_device()

    def reference_steps(self, fp8: bool = False, bf16: bool = False
                        ) -> dict:
        """The reference's losses, first gradient and change over the
        checked steps: with ``bf16`` under bfloat16 autocast, as the
        configuration states, else in float32; with ``fp8`` its
        convolutions and linear layers in float8
        (``reference/precision.py``)."""
        from contextlib import ExitStack

        from port_bench.reference.config import Config as RConfig
        from port_bench.reference.data.pipeline import \
            preprocess_rois_grouped as rpre
        from port_bench.reference.models import RDPN as RModel
        from port_bench.reference.parallel.train_step import (
            TrainState, make_train_step)
        from port_bench.reference.precision import Float8Compute
        from port_bench.reference.solver import (build_optimizer,
                                                 build_schedule)

        cell = self.ctx.cell
        rcfg = RConfig(exp_name=cell["config"]).apply_opts(self.ctx.opts)
        model = RModel(rcfg)
        model.load_state_dict(self.weights)
        model = model.to(self.ctx.device)
        opt = build_optimizer(rcfg, model)
        state = TrainState(model, opt, cell["start_step"])
        step = make_train_step(rcfg, build_schedule(rcfg,
                                                    cell["total_iters"]))
        params = [p for _, p in model.named_parameters()]
        p0 = [p.detach().clone() for p in params]
        losses, grad = [], None
        with hctx.full_float32():
            for i in range(cell["checked_steps"]):
                frames, rois, cs, aug = self.inputs(i)
                batch = rpre(rcfg, frames, rois, train=True,
                             center_scale=cs, aug_params=aug)
                with ExitStack() as stack:
                    if fp8:
                        stack.enter_context(Float8Compute())
                    state, metrics = step(state, batch, bf16)
                losses.append(float(metrics["total_loss"]))
                if i == 0:
                    grad = self._first_grad(opt, params)
        change = self._leaf_norms([p.detach() - q for p, q in
                                   zip(params, p0)])
        del model, opt, state, p0
        hctx.free_device()
        return {"loss": losses, "grad": grad, "change": change}

    @staticmethod
    def compare(prog: dict, ref: dict) -> dict[str, float]:
        """``loss_gap``: the worst step's loss; ``grad_leaf_gap`` and
        ``update_leaf_gap``: by the worst leaf, the first gradient's norm
        and the change's norm; ``update_median_gap``: the median leaf's
        change gap (leaves the reference moves by rounding alone left out
        of the change). Each relative to the reference."""
        loss = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(prog["loss"], ref["loss"]))
        g_ref = ref["grad"]
        moved = g_ref >= 1e-3 * g_ref.median()
        grad = hctx.rel_gap(prog["grad"].to(g_ref.device), g_ref)
        change = hctx.rel_gap(prog["change"].to(g_ref.device)[moved],
                              ref["change"][moved])
        change = change.nan_to_num(math.inf)
        return {"loss_gap": loss if math.isfinite(loss) else math.inf,
                "grad_leaf_gap": float(grad.nan_to_num(math.inf).max()),
                "update_leaf_gap": float(change.max()),
                "update_median_gap": float(change.median())}

    def check(self, window) -> dict[str, float]:
        return self.compare(self.program, self.reference_steps(
            bf16=self.cfg.solver.amp))

    def control_steps(self) -> dict:
        """The control: the reference computed in float8 in the program's
        place (under bfloat16 autocast where the configuration states it,
        its convolutions and linear layers in float8)."""
        return self.reference_steps(fp8=True, bf16=self.cfg.solver.amp)
