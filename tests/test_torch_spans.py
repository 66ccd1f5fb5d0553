"""The program's spans (``utils/profiling.span``): free while no profiler
records, and under ``utils.profiling.trace`` the ranges of the
preprocessing, the eval step, the model and the train step, nested as
an operator reads them in ``main --profile``'s trace."""

import json

import pytest
import torch

from rdpn6d_tpu_torch.config import Config
from rdpn6d_tpu_torch.data.pipeline import preprocess_rois_grouped
from rdpn6d_tpu_torch.data.synthetic import dummy_grouped_inputs
from rdpn6d_tpu_torch.models import RDPN, init_weights
from rdpn6d_tpu_torch.parallel import (create_train_state, make_eval_step,
                                       make_train_step)
from rdpn6d_tpu_torch.solver import build_schedule
from rdpn6d_tpu_torch.utils import profiling

TINY = ["backbone.depth=18", "backbone.input_res=64", "head.out_res=16",
        "head.num_regions=4", "head.num_filters=32", "data.input_res=64",
        "data.out_res=16", "solver.warmup_iters=0",
        # colour aug on every ROI, the eval step refined by RANSAC-Kabsch
        "data.color_aug_prob=1.0", 'data.color_aug_type="code"',
        "test.use_pnp=true"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _calls():
    """One preprocessing call, one eval step and one train step of the
    tiny model on the CPU."""
    cfg = Config().apply_opts(TINY)
    frames, rois = dummy_grouped_inputs(cfg, n_frames=2, rois_per_frame=2,
                                        seed=7)
    frames = {k: torch.from_numpy(v) for k, v in frames.items()}
    rois = {k: torch.from_numpy(v) for k, v in rois.items()}
    model = init_weights(RDPN(cfg), torch.Generator().manual_seed(0))
    schedule = build_schedule(cfg, 100)
    state = create_train_state(cfg, model, lr=schedule(0))
    step = make_train_step(cfg, schedule)
    evaluate = make_eval_step(cfg, model.eval())

    def run():
        gen = torch.Generator().manual_seed(3)
        batch = preprocess_rois_grouped(cfg, frames, rois, train=True,
                                        generator=gen)
        evaluate(preprocess_rois_grouped(cfg, frames, rois))
        step(state, batch)

    return run


def test_span_is_one_shared_noop_without_a_profiler(monkeypatch):
    assert not torch.autograd._profiler_enabled()
    noop = profiling.span("pre")
    assert noop is profiling.span("step.loss") is profiling._NO_SPAN
    with profiling.span("eval") as inside:
        assert inside is None

    def record(name):
        raise AssertionError(f"recorded {name} with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", record)
    _calls()()


@pytest.fixture(scope="module")
def spans(tmp_path_factory):
    """The ``rdpn.*`` ranges of one traced run of ``_calls``, in order,
    each with the name of the innermost ``rdpn.*`` range enclosing it on
    its thread (None at the top)."""
    run = _calls()
    logdir = tmp_path_factory.mktemp("prof")
    with profiling.trace(str(logdir)):
        run()
    with open(logdir / "trace.json") as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e["name"].startswith(profiling.SPAN_PREFIX)]
    events.sort(key=lambda e: (e["ts"], -e["dur"]))
    out, stack = [], []
    for e in events:
        while stack and (stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]
                         or stack[-1]["tid"] != e["tid"]):
            stack.pop()
        out.append((e["name"][len(profiling.SPAN_PREFIX):],
                    stack[-1]["name"][len(profiling.SPAN_PREFIX):]
                    if stack else None))
        stack.append(e)
    return out


def _children(spans, parent):
    return [name for name, p in spans if p == parent]


def test_top_level_spans(spans):
    assert _children(spans, None) == ["pre", "pre", "eval", "step"]


def test_preprocess_spans(spans):
    # the train call: crop, colour aug, labels; the eval call: the crop
    assert _children(spans, "pre") == ["pre.crop", "pre.color_aug",
                                       "pre.labels", "pre.crop"]


def test_eval_spans(spans):
    assert _children(spans, "eval") == ["model.trunk", "model.head",
                                        "model.pnp", "eval.kabsch"]


def test_train_step_spans(spans):
    assert _children(spans, "step") == ["step.forward", "step.loss",
                                        "step.backward", "step.optimizer"]
    assert _children(spans, "step.forward") == ["model.trunk", "model.head",
                                                "model.pnp"]
    for leaf in ("pre.crop", "pre.color_aug", "pre.labels", "eval.kabsch",
                 "model.trunk", "model.head", "model.pnp", "step.loss",
                 "step.backward", "step.optimizer"):
        assert _children(spans, leaf) == []
