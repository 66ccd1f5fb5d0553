"""Inference driver: timed evaluation over a test split.

Counterpart of ``rdpn6d_tpu/engine/inference.py``. The eval step returns
device tensors without waiting (CUDA runs asynchronously), so batch i+1 is
launched before batch i's poses are read back (``.cpu()`` is the only
wait), and host work overlaps the device. The steady-state window skips
the first ``num_warmup`` batches; ``wall_s`` / ``process_s`` / ``n_rois``
are the JAX package's statistics.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Iterator

import numpy as np

from ..data.inout import save_bop_results_csv
from ..evaluation.evaluator import PoseEvaluator, format_table

logger = logging.getLogger("rdpn6d")


def inference_on_dataset(
    eval_step: Callable[[dict], dict],
    batches: Iterator[tuple[dict, list[dict]]],
    evaluator: PoseEvaluator,
    num_warmup: int = 2,
) -> dict[str, float]:
    """``batches`` yields (device batch, metadata rows); row i carries
    obj_name/scene_id/im_id/R_gt/t_gt/K (and score) of ROI i. The
    evaluator takes one batched append per step."""
    total_process = 0.0
    n_rois = 0
    n_timed = 0
    t_first = None

    def consume(out, meta, per):
        rot = out["rot_ego"].float().cpu().numpy()   # waits for THIS batch
        trans = out["trans"].float().cpu().numpy()
        n = len(meta)
        evaluator.process_batch(
            [row["obj_name"] for row in meta], rot[:n], trans[:n],
            np.stack([row["R_gt"] for row in meta]),
            np.stack([row["t_gt"] for row in meta]),
            np.stack([row["K"] for row in meta]),
            scene_ids=np.array([row.get("scene_id", 0) for row in meta]),
            im_ids=np.array([row.get("im_id", 0) for row in meta]),
            scores=np.array([row.get("score", 1.0) for row in meta],
                            np.float32),
            times=np.full(n, per, np.float32))

    pending = None  # (out, meta, t_launched)
    i = -1
    for i, (batch, meta) in enumerate(batches):
        t0 = time.perf_counter()
        out = eval_step(batch)           # launched, not waited for
        if pending is not None:
            p_out, p_meta, p_t0 = pending
            consume(p_out, p_meta, (t0 - p_t0) / max(len(p_meta), 1))
            t2 = time.perf_counter()
            if i > num_warmup:
                total_process += t2 - t0
                n_timed += len(p_meta)
                if t_first is None:
                    t_first = p_t0
            n_rois += len(p_meta)
        pending = (out, meta, t0)
    if pending is not None:
        p_out, p_meta, p_t0 = pending
        t_flush = time.perf_counter()
        consume(p_out, p_meta, t_flush - p_t0)
        n_rois += len(p_meta)
        # batch j is timed when j + 1 > num_warmup, as in the loop: a run
        # shorter than the warm-up window reports no steady-state rate
        if i + 1 > num_warmup:
            total_process += time.perf_counter() - t_flush
            n_timed += len(p_meta)
            if t_first is None:
                t_first = p_t0
    total_wall = (time.perf_counter() - t_first) if t_first else 0.0
    if n_rois:
        logger.info(
            f"inference: {n_rois} rois, "
            f"{1000 * total_wall / max(n_timed, 1):.2f} ms/roi wall, "
            f"{1000 * total_process / max(n_timed, 1):.3f} ms/roi host "
            f"process (overlapped), "
            f"{n_timed / max(total_wall, 1e-9):.1f} poses/sec")
    return {
        "wall_s": total_wall,        # steady-state window
        "process_s": total_process,  # host processing, overlapped
        "n_rois": n_rois,
        "n_timed": n_timed,
    }


def evaluate_and_report(evaluator: PoseEvaluator,
                        obj2id: dict[str, int] | None = None,
                        csv_path: str | None = None) -> dict[str, Any]:
    """Score, log the table, and write the BOP19 CSV when asked."""
    result = evaluator.evaluate()
    logger.info("\n" + format_table(result))
    if csv_path and obj2id is not None:
        save_bop_results_csv(csv_path, evaluator.bop_rows(obj2id))
        logger.info(f"wrote BOP19 CSV: {csv_path}")
    return result
