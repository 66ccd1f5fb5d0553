"""Split evaluation: records -> decode -> preprocess and model on the device
-> PoseEvaluator -> tables, BOP19 CSV, recall curves, BOP19 AR.

Counterpart of ``rdpn6d_tpu/engine/eval_runner.py`` (``_eval_setup``,
``run_eval``, ``_bop19_scores``, ``coord_regression_eval``), as ``main
--eval-only`` drives it on a checkpoint and the trainer drives it on its
live model; ``main --eval-only --debug`` drives the coordinate-regression
debug eval.
Frames are grouped into batches as the JAX package groups them (frames per
batch from the split's instances per frame) and cross to the device once
per image; eager PyTorch needs no fixed shape, so batches are not padded
(only the BOP CSV's ``time`` column can differ from the JAX package's).
``test.int8`` evaluates the W8A8 model (``models/quant.py``); with
``test.int8_static`` its scales are calibrated on the first eval batch. A
live trainer model is evaluated in int8 through a serving copy built at
every call with its current weights.
In a process group (``parallel/mesh.py``) each rank infers its frame shard
of the split (``shard_records_by_frame``), the predictions are gathered,
and rank 0 scores them over the whole split; the other ranks return
``{"stats": ...}``.
The BOP19 AR takes VSD when ``test.error_types`` asks for ``vsd``: the
eval meshes' faces rendered on the host (``ops/rasterizer.py``) against
the scene depth.
Each batch goes through ``parallel.make_eval_step``, as in the JAX
package, so ``test.use_pnp`` refines the poses by RANSAC-Kabsch there.
"""

from __future__ import annotations

import logging
import os
from typing import Any

import numpy as np
import torch

from ..config import Config
from ..parallel import mesh
from ..utils.device import resolve_device

logger = logging.getLogger("rdpn6d")


def shard_records_by_frame(records: list[dict], process_index: int,
                           process_count: int) -> list[dict]:
    """This rank's test shard at frame granularity: every instance of a
    (scene_id, im_id) lands on one rank, so a frame still crosses to the
    device once; the shards partition the split."""
    fkeys = sorted({(r["scene_id"], r["im_id"]) for r in records})
    mine = set(fkeys[process_index::process_count])
    return [r for r in records if (r["scene_id"], r["im_id"]) in mine]


def _in_frame_order(chunks: list[dict], records: list[dict]) -> dict:
    """Pooled prediction chunks as one, its rows in the order of the
    frames' first records (stable within a frame): the order one process
    appends them in, whatever the shards."""
    order: dict[tuple[int, int], int] = {}
    for r in records:
        order.setdefault((r["scene_id"], r["im_id"]), len(order))
    allp = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    key = np.array([order[(s, i)] for s, i in
                    zip(allp["scene_id"].tolist(), allp["im_id"].tolist())])
    idx = np.argsort(key, kind="stable")
    return {k: v[idx] for k, v in allp.items()}


_EVAL_MEMO: dict = {}


def _eval_setup(cfg: Config, split_name: str, split: Any, ref: Any,
                dets_path: str | None):
    """The disk-parsing half of run_eval: records (target-filtered, with
    detections attached), GT counts and the asset banks; memoized by
    run_eval."""
    from ..data.assets import load_class_assets
    from ..data.bop import build_split_records, load_bop19_targets
    from ..data.detections import attach_detections, load_detections

    records = build_split_records(split, flatten=True)

    # BOP19 target filtering: score exactly the published target list
    targets = None
    if split.targets_file:
        tpath = os.path.join(ref.root, split.targets_file)
        if os.path.exists(tpath):
            targets = load_bop19_targets(ref, split.targets_file)
            if split.objs:
                # an object-subset split scores only its objects' targets
                sel = {ref.obj2id[o] for o in split.objs}
                targets = [t for t in targets if t["obj_id"] in sel]
            tset = {(t["scene_id"], t["im_id"], t["obj_id"])
                    for t in targets}
            n_before = len(records)
            records = [r for r in records
                       if (r["scene_id"], r["im_id"], r["obj_id"]) in tset]
            logger.info(f"BOP19 targets: {n_before} -> {len(records)} "
                        f"instances ({len(tset)} targets)")
        else:
            logger.warning(f"split declares targets_file but {tpath} "
                           "is absent; scoring ALL images")

    # GT counts BEFORE detections attach: recall denominators include the
    # instances the detector misses
    id2name = {oid: ref.id2obj[oid] for oid in ref.obj_ids}
    n_gts: dict[str, int] = {}
    for rec in records:
        name = id2name[rec["obj_id"]]
        n_gts[name] = n_gts.get(name, 0) + 1

    # estimated boxes: the dets_path argument wins, else the config's file
    # aligned with data.test_datasets
    if not dets_path and cfg.test.test_bbox_type == "est" \
            and cfg.data.det_files_test:
        try:
            di = list(cfg.data.test_datasets).index(split_name)
        except ValueError:
            if len(cfg.data.det_files_test) != 1:
                raise ValueError(
                    f"split {split_name!r} is not in cfg.data."
                    f"test_datasets {cfg.data.test_datasets} — cannot "
                    "pick among multiple det_files_test; pass dets_path")
            di = 0
        if len(cfg.data.det_files_test) == 1:
            di = 0          # one shared detections file for every split
        elif di >= len(cfg.data.det_files_test):
            raise ValueError(
                f"data.det_files_test has {len(cfg.data.det_files_test)} "
                f"entries but split {split_name!r} is test_datasets[{di}] "
                "— the lists must align (or pass a single shared file)")
        dets_path = cfg.data.det_files_test[di]
    # objects of the GT, before detections attach: an object the detector
    # misses still needs assets for its failure rows
    present = sorted({rec["obj_id"] for rec in records})
    if dets_path:
        records = attach_detections(records, load_detections(dets_path),
                                    topk_per_obj=cfg.data.det_topk_per_obj)
    logger.info(f"{len(records)} test instances in {split_name}")
    objs = [ref.id2obj[oid] for oid in present]
    assets = load_class_assets(ref, cfg.head.num_regions,
                               cfg.loss.num_pm_points, objs=objs)
    # scored on the decimated eval meshes (the train meshes when
    # models_eval/ is absent)
    eval_assets = load_class_assets(ref, cfg.head.num_regions,
                                    cfg.loss.num_pm_points, objs=objs,
                                    use_eval_models=True)
    return records, targets, n_gts, id2name, assets, eval_assets


def _load_model(cfg: Config, ckpt_dir: str, allow_random_init: bool,
                device: torch.device, dtype: torch.dtype):
    from ..models import RDPN, init_weights
    from ..models.quant import serving_mode
    from .checkpoint import CheckpointManager

    int8, static = serving_mode(cfg)
    model = RDPN(cfg, int8=int8, int8_static=static)
    mgr = CheckpointManager(ckpt_dir)
    if mgr.latest_step() is not None:
        from ..parallel import TrainState

        mgr.restore(TrainState(model=model, optimizer=None))
        logger.info(f"restored step {mgr.latest_step()} from {mgr.directory}")
    elif allow_random_init:
        init_weights(model, torch.Generator().manual_seed(0))
    else:
        raise FileNotFoundError(
            f"no checkpoint in {ckpt_dir!r} — refusing to evaluate "
            "random-init weights (pass allow_random_init=True for smoke "
            "runs)")
    # Int8Conv keeps its weight in float32 under the cast
    return model.to(device=device, dtype=dtype).eval()


def _int8_serving_copy(cfg: Config, live: Any, dtype: torch.dtype):
    """The int8 model that evaluates the trainer's live ``live`` model,
    built at each call with the live weights, in ``dtype``, on the live
    model's device. The live model is not touched."""
    from ..models import RDPN
    from ..models.quant import serving_mode

    int8, static = serving_mode(cfg)
    copy = RDPN(cfg, int8=int8, int8_static=static).to(
        device=next(live.parameters()).device, dtype=dtype)
    copy.load_state_dict(live.state_dict())   # copy_ casts as .to does
    return copy.eval()


def run_eval(cfg: Config, ckpt_dir: str, split_name: str,
             dets_path: str = "", batch_size: int = 32,
             csv_path: str | None = None,
             allow_random_init: bool = False,
             dtype: torch.dtype = torch.bfloat16,
             device: str | torch.device | None = None,
             model: Any = None) -> dict[str, Any]:
    """Evaluate the latest checkpoint in ``ckpt_dir`` on a split, or with
    ``model`` (an ``RDPN``, as the trainer holds it) that live model on
    its own device. The live model is not converted: it runs in eval mode
    under autocast to ``dtype`` (none for float32) and is handed back in
    the mode it came in, its weights and statistics untouched. Returns
    {per_obj, mean, errors (per-object error arrays), stats, and bop19
    when the split has targets and test.error_types asks for mssd/mspd}."""
    from ..data.bop import get_split
    from ..data.loader import RecordDecoder
    from ..data.pipeline import preprocess_rois_grouped
    from ..data.refs import get_ref
    from ..evaluation.evaluator import PoseEvaluator
    from ..parallel import make_eval_step
    from .inference import evaluate_and_report, inference_on_dataset

    device = next(model.parameters()).device if model is not None \
        else resolve_device(device)
    split = get_split(split_name)
    ref = get_ref(split.ref_name)

    # records/targets/assets are pure in (split, dataset root, detection
    # config); keyed by root so a re-pointed RDPN6D_DATA_ROOT is re-read
    memo_key = ("setup", split_name, ref.root, dets_path,
                cfg.test.test_bbox_type,
                tuple(cfg.data.det_files_test or ()),
                int(cfg.data.det_topk_per_obj),
                int(cfg.head.num_regions), int(cfg.loss.num_pm_points))
    cached = _EVAL_MEMO.get(memo_key)
    if cached is None:
        cached = _eval_setup(cfg, split_name, split, ref, dets_path)
        _EVAL_MEMO[memo_key] = cached
    records, targets, n_gts, id2name, assets, eval_assets = cached
    n_gts = dict(n_gts)  # the evaluator may hold it; never share the memo's
    # rank 0 scores the pooled predictions against the whole split
    all_records = records
    if mesh.in_group():
        records = shard_records_by_frame(records, mesh.rank(), mesh.world())
        logger.info(f"rank {mesh.rank()}/{mesh.world()}: {len(records)} "
                    "instances in this rank's frame shard")

    from ..models.quant import serving_mode

    int8, static = serving_mode(cfg)
    live = model is not None
    if not live:
        model = _load_model(cfg, ckpt_dir, allow_random_init, device, dtype)
    elif int8:
        model = _int8_serving_copy(cfg, model, dtype)
    autocast = live and not int8 and dtype != torch.float32
    # the preprocessing in float32 whatever the model's dtype, as the JAX
    # package's: only the forward runs under autocast
    step = make_eval_step(cfg, model, autocast=dtype if autocast else None)

    def preprocess(b):
        return preprocess_rois_grouped(cfg, b["frames"], b["rois"])

    def eval_step(b):
        with torch.no_grad():
            return step(preprocess(b))

    def asset(oid, key):
        return eval_assets.for_obj(oid)[key]

    evaluator = PoseEvaluator(
        models={ref.id2obj[o]: asset(o, "points")
                for o in eval_assets.obj_ids},
        diameters={ref.id2obj[o]: float(asset(o, "diameter"))
                   or ref.diameter_m(o) for o in eval_assets.obj_ids},
        sym_rots={ref.id2obj[o]: asset(o, "sym_rots")
                  for o in eval_assets.obj_ids},
        n_gts=n_gts, precision=cfg.test.eval_precision, device=device)

    decoder = RecordDecoder(cfg)
    # frames per batch from the split's instances per frame: one-instance
    # datasets (LM) fill whole batches, cluttered ones move fewer frames
    n_frames_total = max(
        len({(r["scene_id"], r["im_id"]) for r in records}), 1)
    inst_per_frame = max(len(records) / n_frames_total, 1.0)
    max_frames = int(min(batch_size,
                         max(1, round(batch_size / inst_per_frame))))

    def _host_bbox(rec) -> np.ndarray | None:
        bbox = rec.get("bbox_visib")
        if bbox is not None:
            b = np.asarray(bbox, np.float32)
            return np.array([b[0], b[1], b[0] + b[2], b[1] + b[3]],
                            np.float32) if rec.get(
                "bbox_mode", "xywh") == "xywh" and b.shape[0] == 4 else b
        # the mask (or label image) through the decoder's LRU
        m = decoder._mask_visib(rec)
        if m is None or not m.any():
            return None
        ys, xs = np.nonzero(m)
        return np.array([xs.min(), ys.min(), xs.max(), ys.max()],
                        np.float32)

    def _flush(frames_l, rois_l, meta):
        def stack(rows, k, dt=None):
            a = np.stack([r[k] for r in rows])
            return torch.from_numpy(a if dt is None else a.astype(dt)) \
                .to(device)

        # raw depth crosses as int32: torch's uint16 support is partial
        frames = {"rgb": stack(frames_l, "rgb"),
                  "depth_raw": stack(frames_l, "depth_raw", np.int32),
                  "depth_factor": stack(frames_l, "depth_factor"),
                  "K": stack(frames_l, "K")}
        rois = {k: stack(rois_l, k) for k in rois_l[0]}
        return {"frames": frames, "rois": rois}, meta

    def batches():
        frames_l: list[dict] = []
        rois_l: list[dict] = []
        meta: list[dict] = []
        fmap: dict[tuple[int, int], int] = {}
        for rec in records:
            fkey = (rec["scene_id"], rec["im_id"])
            if fkey not in fmap and (len(frames_l) == max_frames
                                     or len(rois_l) == batch_size) \
                    or fkey in fmap and len(rois_l) == batch_size:
                if meta:  # all-skipped accumulations just reset
                    yield _flush(frames_l, rois_l, meta)
                frames_l, rois_l, meta, fmap = [], [], [], {}
            if fkey not in fmap:
                try:
                    frame = decoder.read_frame(rec)
                except (FileNotFoundError, OSError) as e:
                    logger.warning(f"skip {rec['rgb_path']}: {e}")
                    continue
                fmap[fkey] = len(frames_l)
                frames_l.append(frame)
            bbox = _host_bbox(rec)
            if bbox is None:
                logger.warning(f"skip instance without bbox: {fkey} "
                               f"obj {rec['obj_id']}")
                continue
            a = assets.for_obj(rec["obj_id"])
            rois_l.append({
                "frame_idx": np.int64(fmap[fkey]),
                "bbox": bbox,
                "fps": a["fps"].astype(np.float32),
                "extent": a["extent"].astype(np.float32),
                # the full-ref class index, as the JAX package feeds it
                "roi_cls": np.int64(rec["cls_idx"]),
            })
            meta.append({
                "obj_name": id2name[rec["obj_id"]],
                "R_gt": rec["R"], "t_gt": rec["t"], "K": rec["K"],
                "scene_id": rec["scene_id"], "im_id": rec["im_id"],
                "score": rec.get("det_score", 1.0),
            })
        if meta:
            yield _flush(frames_l, rois_l, meta)

    batch_iter = batches()
    if int8 and static:
        # static int8: the scales come from the first eval batch, then
        # every batch serves with them
        from itertools import chain

        from ..models.quant import calibrate_quant

        first = next(batch_iter, None)
        if first is not None:
            with torch.no_grad():
                calibrate_quant(model, [preprocess(first[0])])
            batch_iter = chain([first], batch_iter)
            logger.info("int8 static scales calibrated on the first eval "
                        "batch")

    was_training = model.training
    model.eval()
    try:
        stats = inference_on_dataset(eval_step, batch_iter, evaluator)
    finally:
        model.train(was_training)

    if mesh.in_group():
        pooled = mesh.gather_predictions(evaluator.chunks)
        evaluator.reset()
        if pooled:
            evaluator.merge_chunks([_in_frame_order(pooled, all_records)])
        if not mesh.is_main():
            return {"stats": stats}

    csv = csv_path or os.path.join(cfg.train.output_dir,
                                   f"{split_name}_bop19.csv")
    result = evaluate_and_report(evaluator, obj2id=ref.obj2id, csv_path=csv)
    result["errors"] = evaluator.compute_errors()

    if cfg.test.plots:
        from ..evaluation.plots import dump_recall_curves

        errs = result["errors"]
        dump_recall_curves(
            errs, {o: evaluator.diameters[o] for o in errs},
            os.path.join(os.path.dirname(os.path.abspath(csv)),
                         f"plots_{split_name}"))

    # BOP19 localization AR when the config asks for toolkit error types
    err_types = {t.strip() for t in cfg.test.error_types.split(",")}
    if targets is not None and err_types & {"vsd", "mssd", "mspd"}:
        result["bop19"] = _bop19_scores(ref, all_records, targets,
                                        evaluator, eval_assets,
                                        with_vsd="vsd" in err_types)
        logger.info(f"BOP19 AR: {result['bop19']}")

    result["stats"] = stats
    return result


def coord_regression_eval(cfg: Config, ckpt_dir: str, split_name: str,
                          batch_size: int = 16, max_batches: int = 0,
                          dtype: torch.dtype = torch.bfloat16,
                          device: str | torch.device | None = None
                          ) -> dict[str, float]:
    """Debug eval: the masked L1 of the predicted against the GT
    normalized coordinates, sum |coord - roi_xyz| * visib over sum 3 *
    visib of every instance of the split.

    Each instance goes through the flat path's decode
    (``RecordDecoder.__call__``, eval mode) and ``preprocess_batch`` with
    the train labels, the DZI box, colour aug and background replacement
    off, then the model's eval outputs (``parallel.make_eval_step``),
    ``batch_size`` instances a batch (at most ``max_batches`` batches, 0
    for all); instances that cannot be decoded are skipped. The model is
    the latest checkpoint in ``ckpt_dir`` in ``dtype``. Every rank of a process group scores the whole split. Returns
    {coord_l1, n} (n the instances scored)."""
    from ..data.assets import load_class_assets
    from ..data.bop import build_split_records, get_split
    from ..data.loader import RecordDecoder, SkipRecord
    from ..data.pipeline import preprocess_batch
    from ..data.refs import get_ref
    from ..parallel import make_eval_step

    dbg_cfg = cfg.apply_opts([
        'data.dzi_type="none"', "data.color_aug_prob=0.0",
        "data.change_bg_prob=0.0"])
    split = get_split(split_name)
    ref = get_ref(split.ref_name)
    records = build_split_records(split, flatten=True)
    present = sorted({rec["obj_id"] for rec in records})
    assets = load_class_assets(ref, cfg.head.num_regions,
                               cfg.loss.num_pm_points,
                               objs=[ref.id2obj[oid] for oid in present])
    decoder = RecordDecoder(dbg_cfg, assets, train=False)
    device = resolve_device(device)
    step = make_eval_step(cfg, _load_model(cfg, ckpt_dir, False, device,
                                           dtype))

    tot_err = tot_cnt = 0.0
    n = 0
    for i in range(0, len(records), batch_size):
        if max_batches and i // batch_size >= max_batches:
            break
        samples = []
        for rec in records[i:i + batch_size]:
            try:
                samples.append(decoder(rec))
            except (FileNotFoundError, OSError, SkipRecord):
                continue
        if not samples:
            continue
        stacked = {k: torch.from_numpy(np.stack([s[k] for s in samples])
                                       ).to(device) for k in samples[0]}
        with torch.no_grad():
            batch = preprocess_batch(dbg_cfg, stacked, train=True)
            out = step(batch)
        m = batch["roi_mask_visib"][..., None]
        err = (out["coord"].float() - batch["roi_xyz"]).abs() * m
        tot_err += float(err.sum(dim=(1, 2, 3)).sum())
        tot_cnt += float((m.sum(dim=(1, 2, 3)) * 3.0).sum())
        n += len(samples)
    l1 = tot_err / max(tot_cnt, 1.0)
    logger.info(f"coord regression debug [{split_name}]: masked L1 = "
                f"{l1:.5f} over {n} instances")
    return {"coord_l1": l1, "n": n}


def _bop19_scores(ref: Any, records: list[dict], targets: list[dict],
                  evaluator: Any, eval_assets: Any,
                  with_vsd: bool) -> dict[str, float]:
    """MSSD/MSPD (and VSD) average recalls over the BOP19 target list.
    VSD renders the eval meshes' faces; a mesh without faces skips VSD
    with a warning, as the JAX package does."""
    from functools import lru_cache

    from ..data.loader import _imread_depth
    from ..evaluation.bop_score import (
        bop19_average_recalls,
        make_vsd_error_fn,
    )

    gts: dict[tuple[int, int], list[dict]] = {}
    depth_info: dict[tuple[int, int], tuple[str, float]] = {}
    for r in records:
        key = (r["scene_id"], r["im_id"])
        gts.setdefault(key, []).append(
            {"obj_id": r["obj_id"], "R": r["R"], "t": r["t"], "K": r["K"]})
        depth_info[key] = (r["depth_path"], r["depth_factor"])

    def bank(key):
        return {oid: eval_assets.for_obj(oid)[key]
                for oid in eval_assets.obj_ids}

    diameters = {oid: float(eval_assets.for_obj(oid)["diameter"])
                 or ref.diameter_m(oid) for oid in eval_assets.obj_ids}

    vsd_fn = None
    if with_vsd:
        from ..data.inout import load_ply

        meshes: dict | None = {}
        for oid in eval_assets.obj_ids:
            ply = load_ply(os.path.join(ref.eval_model_dir,
                                        f"obj_{oid:06d}.ply"),
                           vertex_scale=ref.vertex_scale)
            if ply.get("faces") is None or not len(ply["faces"]):
                logger.warning(f"obj {oid}: eval mesh has no faces; "
                               "skipping VSD")
                meshes = None
                break
            meshes[oid] = (ply["pts"].astype(np.float32),
                           np.asarray(ply["faces"], np.int32))
        if meshes is not None:
            # ~1.2 MB a 480x640 float32 depth frame: 64 hold ~80 MB, and
            # the scorer walks targets frame by frame, so a few frames'
            # interleaving is all the cache has to absorb
            @lru_cache(maxsize=64)
            def _depth(scene_id: int, im_id: int) -> np.ndarray:
                path, factor = depth_info[(scene_id, im_id)]
                return _imread_depth(path, factor)

            vsd_fn = make_vsd_error_fn(meshes, _depth, diameters)

    return bop19_average_recalls(
        evaluator.bop_rows(ref.obj2id), gts, targets, bank("points"),
        bank("sym_rots"), diameters, im_width=ref.width, with_vsd=vsd_fn,
        sym_trans=bank("sym_trans"))
