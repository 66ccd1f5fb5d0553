"""The weight carrier: a flax ``params``/``batch_stats`` tree, as numpy,
to the port's ``state_dict`` -- and a flax gradient tree (the params
structure) to the port's parameter names.

The JAX package saves served weights as a pickle of numpy trees
(``engine/predictor.py``'s ``params_pkl``), named by flax's auto-naming:
``backbone/{Conv_0,BatchNorm_0,BasicBlock_i/...}``,
``spatial_net/{Conv_i,BatchNorm_i}``,
``dense_head/{ConvTranspose_0,Conv_j,BatchNorm_j}``,
``pnp_net/{Conv_j,GroupNorm_j,Dense_j}`` (a point PnP head's
``pnp_net/Dense_0..6``) and, with ``pnp.r_only``,
``trans_head/{Conv_j,BatchNorm_j,Dense_j}``. The port's keys are the
reference checkpoint's (``backbone.*``, ``backbone.spatial_net.*``,
``rot_head_net.features.*``, ``pnp_net.*``, ``trans_head_net.*``), the
layout that ``rdpn6d_tpu/utils/torch_convert.convert_rdpn_checkpoint``
reads back; the point heads, which the reference checkpoint lacks, take
the port's own names (``models/point_pnp.py``). A space-to-depth stem's
[4, 4, 12, 64] kernel maps as any conv's.

Layouts: conv kernels HWIO -> OIHW; the transposed conv's
[kh, kw, out, in] -> [in, out, kh, kw]; dense kernels [in, out] -> [out, in];
``fc1``'s (and TransHead's first linear's) input axis from flax's NHWC
flatten order to torch's NCHW one, over the map it flattens (derived from
the config, not assumed 8x8). ``loss.use_mtl``'s ``log_var_*`` leaves
sit at the top of both.

int8 serving's calibrated scales: the flax ``quant`` collection holds an
``act_amax`` (a scalar, or one value per input channel) at the path of each
static ``Int8Conv``; ``load_quant`` puts them into the port's
``Int8Conv.act_amax`` buffers and ``quant_tree`` reads them back.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..config import Config
from ..models.resnet import RESNET_SPECS


class _Tree:
    """Reads leaves of a nested dict, recording every missing path."""

    def __init__(self, params: dict, stats: dict):
        self.trees = {"params": params or {}, "batch_stats": stats or {}}
        self.missing: list[str] = []

    def get(self, coll: str, path: tuple[str, ...]) -> np.ndarray | None:
        node: Any = self.trees[coll]
        for k in path:
            if not isinstance(node, dict) or k not in node:
                self.missing.append(f"{coll}/" + "/".join(path))
                return None
            node = node[k]
        arr = np.asarray(node)     # float64 trees keep their precision
        return arr if arr.dtype == np.float64 else arr.astype(np.float32)


class _Writer:
    def __init__(self, tree: _Tree, with_stats: bool = True):
        self.t = tree
        self.with_stats = with_stats
        self.sd: dict[str, np.ndarray] = {}

    def put(self, key: str, value, fn=None):
        if value is not None:   # a missing leaf is recorded by _Tree.get
            self.sd[key.lstrip(".")] = fn(value) if fn is not None \
                else value

    def conv(self, key: str, path: tuple[str, ...]):
        self.put(key + ".weight", self.t.get("params", path + ("kernel",)),
                 lambda k: k.transpose(3, 2, 0, 1))
        node = self.t.trees["params"]
        for k in path:
            node = node.get(k, {}) if isinstance(node, dict) else {}
        if "bias" in node:
            self.put(key + ".bias", self.t.get("params", path + ("bias",)))

    def conv_t(self, key: str, path: tuple[str, ...]):
        self.put(key + ".weight", self.t.get("params", path + ("kernel",)),
                 lambda k: k.transpose(3, 2, 0, 1))

    def bn(self, key: str, path: tuple[str, ...]):
        self.put(key + ".weight", self.t.get("params", path + ("scale",)))
        self.put(key + ".bias", self.t.get("params", path + ("bias",)))
        if not self.with_stats:
            return
        self.put(key + ".running_mean",
                 self.t.get("batch_stats", path + ("mean",)))
        self.put(key + ".running_var",
                 self.t.get("batch_stats", path + ("var",)))
        self.put(key + ".num_batches_tracked", np.zeros((), np.int64))

    def gn(self, key: str, path: tuple[str, ...]):
        self.put(key + ".weight", self.t.get("params", path + ("scale",)))
        self.put(key + ".bias", self.t.get("params", path + ("bias",)))

    def norm(self, kind: str, key: str, prefix: tuple[str, ...], i: int):
        if kind == "BN":
            self.bn(key, prefix + (f"BatchNorm_{i}",))
        else:
            self.gn(key, prefix + (f"GroupNorm_{i}",))

    def dense(self, key: str, path: tuple[str, ...], fn=None):
        self.put(key + ".weight", self.t.get("params", path + ("kernel",)),
                 (lambda k: fn(k.T)) if fn is not None else (lambda k: k.T))
        self.put(key + ".bias", self.t.get("params", path + ("bias",)))


def resnet_state(w: _Writer, depth: int, prefix: str, path: tuple) -> None:
    kind, layers = RESNET_SPECS[depth]
    w.conv(f"{prefix}.conv1", path + ("Conv_0",))
    w.bn(f"{prefix}.bn1", path + ("BatchNorm_0",))
    cls = "BasicBlock" if kind == "basic" else "Bottleneck"
    n_conv = 2 if kind == "basic" else 3
    cin, gi = 64, 0
    for stage, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
        out = planes * (1 if kind == "basic" else 4)
        for i in range(n):
            bp = path + (f"{cls}_{gi}",)
            key = f"{prefix}.layer{stage + 1}.{i}"
            for c in range(n_conv):
                w.conv(f"{key}.conv{c + 1}", bp + (f"Conv_{c}",))
                w.bn(f"{key}.bn{c + 1}", bp + (f"BatchNorm_{c}",))
            stride = 2 if (stage > 0 and i == 0) else 1
            if stride != 1 or cin != out:
                w.conv(f"{key}.downsample.0", bp + (f"Conv_{n_conv}",))
                w.bn(f"{key}.downsample.1", bp + (f"BatchNorm_{n_conv}",))
            cin, gi = out, gi + 1


def pointnet_state(w: _Writer, prefix: str, path: tuple) -> None:
    for i, (conv, bn) in enumerate([("xyz_emb", "xb"), ("conv1", "b1"),
                                    ("conv2", "b2"), ("conv3", "b3")]):
        w.conv(f"{prefix}.{conv}", path + (f"Conv_{i}",))
        w.bn(f"{prefix}.{bn}", path + (f"BatchNorm_{i}",))


def head_state(w: _Writer, num_layers: int, norm: str, prefix: str,
               path: tuple) -> None:
    w.conv_t(f"{prefix}.features.0", path + ("ConvTranspose_0",))
    w.norm(norm, f"{prefix}.features.1", path, 0)
    for j in range(2 * num_layers):
        w.conv(f"{prefix}.features.{3 + 3 * j}", path + (f"Conv_{j}",))
        w.norm(norm, f"{prefix}.features.{4 + 3 * j}", path, j + 1)
    w.conv(f"{prefix}.features.{3 + 6 * num_layers}",
           path + (f"Conv_{2 * num_layers}",))


def _nhwc_to_nchw(key: str, res: int, channels: int):
    def fn(wt):  # [out, H*W*C] in flax order -> torch order
        if wt.shape[1] != res * res * channels:
            raise ValueError(
                f"{key}: {wt.shape[1]} inputs, expected "
                f"{res}x{res}x{channels} from the config")
        return wt.reshape(-1, res, res, channels).transpose(
            0, 3, 1, 2).reshape(wt.shape)
    return fn


def pnp_state(w: _Writer, num_layers: int, norm: str, featdim: int,
              out_res: int, prefix: str, path: tuple) -> None:
    for j in range(num_layers):
        w.conv(f"{prefix}.features.{3 * j}", path + (f"Conv_{j}",))
        w.norm(norm, f"{prefix}.features.{3 * j + 1}", path, j)
    w.dense(f"{prefix}.fc1", path + ("Dense_0",),
            _nhwc_to_nchw(f"{prefix}.fc1", out_res, featdim))
    for j, fc in enumerate(["fc2", "fc_r", "fc_t"], start=1):
        w.dense(f"{prefix}.{fc}", path + (f"Dense_{j}",))


def point_pnp_state(w: _Writer, prefix: str, path: tuple) -> None:
    """``SimplePointPnP`` / ``PointPnP``: flax's Dense_0..6 in order."""
    names = ["mlp.0", "mlp.1", "mlp.2", "fc1", "fc2", "fc_r", "fc_t"]
    for j, name in enumerate(names):
        w.dense(f"{prefix}.{name}", path + (f"Dense_{j}",))


def trans_head_state(w: _Writer, num_layers: int, num_filters: int,
                     in_res: int, prefix: str, path: tuple) -> None:
    """``TransHead`` (flax's BatchNorm head) as the reference's
    ``TransHeadNet``: features.{3j, 3j+1}, linears.{0, 2, 4}."""
    for j in range(num_layers):
        w.conv(f"{prefix}.features.{3 * j}", path + (f"Conv_{j}",))
        w.bn(f"{prefix}.features.{3 * j + 1}", path + (f"BatchNorm_{j}",))
    w.dense(f"{prefix}.linears.0", path + ("Dense_0",),
            _nhwc_to_nchw(f"{prefix}.linears.0", in_res, num_filters))
    w.dense(f"{prefix}.linears.2", path + ("Dense_1",))
    w.dense(f"{prefix}.linears.4", path + ("Dense_2",))


def pnp_out_res(cfg: Config) -> int:
    from ..models.rdpn import head_out_res

    res = head_out_res(cfg)
    for i in range(cfg.pnp.num_layers):
        if i < 3:
            res = (res - 1) // 2 + 1
    return res


def carry(fill, params: dict, batch_stats: dict | None = None,
          with_stats: bool = True) -> dict[str, torch.Tensor]:
    """Run ``fill(writer)`` (which names the leaves to map, e.g.
    ``lambda w: pnp_state(w, 3, "GN", 128, 8, "", ())`` for one
    submodule) over a flax tree and return the torch tensors.
    ``with_stats=False`` maps the parameters only (BatchNorm running
    statistics and counters are left out).

    Raises ValueError naming the missing leaves when the tree does not
    cover what ``fill`` asks for: a partial tree would serve random-init
    weights."""
    tree = _Tree(params, batch_stats or {})
    w = _Writer(tree, with_stats)
    fill(w)
    if tree.missing:
        some = sorted(tree.missing)[:5]
        raise ValueError(
            f"flax tree does not cover the model — {len(tree.missing)} "
            f"missing leaves (e.g. {some}); refusing to mix random-init "
            "values into served weights")
    return {k: torch.from_numpy(np.array(v)) for k, v in w.sd.items()}


def _rdpn_fill(cfg: Config):
    def fill(w: _Writer) -> None:
        resnet_state(w, cfg.backbone.depth, "backbone", ("backbone",))
        pointnet_state(w, "backbone.spatial_net", ("spatial_net",))
        head_state(w, cfg.head.num_layers, cfg.head.norm, "rot_head_net",
                   ("dense_head",))
        if cfg.pnp.pnp_head == "ConvPnPNet":
            pnp_state(w, cfg.pnp.num_layers, cfg.pnp.norm, cfg.pnp.featdim,
                      pnp_out_res(cfg), "pnp_net", ("pnp_net",))
        else:
            point_pnp_state(w, "pnp_net", ("pnp_net",))
        if cfg.pnp.r_only:
            trans_head_state(w, 3, cfg.head.num_filters,
                             cfg.backbone.input_res // 32, "trans_head_net",
                             ("trans_head",))
        if cfg.loss.use_mtl:
            from ..models.rdpn import MTL_LOSSES

            for name in MTL_LOSSES:
                w.put(f"log_var_{name}",
                      w.t.get("params", (f"log_var_{name}",)))
    return fill


def state_dict_from_flax(cfg: Config, params: dict,
                         batch_stats: dict | None = None,
                         ) -> dict[str, torch.Tensor]:
    """Map a flax RDPN tree (numpy leaves) to the port's ``state_dict``."""
    return carry(_rdpn_fill(cfg), params, batch_stats)


def grads_from_flax(cfg: Config, grads: dict) -> dict[str, torch.Tensor]:
    """Map a flax gradient tree (the ``params`` structure) onto the port's
    parameter names, in the port's layouts: the keys of
    ``RDPN.named_parameters()``."""
    return carry(_rdpn_fill(cfg), grads, with_stats=False)


def checkpoint_from_params_pkl(cfg: Config, params_pkl: str, ckpt_dir: str,
                               step: int = 0) -> str:
    """Write a port checkpoint (``engine/checkpoint.py``) of the weights in
    a JAX ``params_pkl`` (the pickle the JAX ``Predictor`` reads), with a
    fresh optimizer of the config; returns the step directory. This is how
    JAX-trained weights reach the port's eval."""
    import pickle

    from ..engine.checkpoint import CheckpointManager
    from ..models import RDPN
    from ..parallel import create_train_state

    with open(params_pkl, "rb") as f:
        loaded = pickle.load(f)
    model = RDPN(cfg)
    model.load_state_dict(state_dict_from_flax(
        cfg, loaded.get("params", {}), loaded.get("batch_stats", {})))
    mgr = CheckpointManager(ckpt_dir)
    mgr.save(step, create_train_state(cfg, model))
    return f"{mgr.directory}/{step}"


class _ConvPaths:
    """A writer that only records each conv's flax path by port name."""

    def __init__(self):
        self.paths: dict[str, tuple[str, ...]] = {}

    def conv(self, key: str, path: tuple[str, ...]):
        self.paths[key.lstrip(".")] = path

    def conv_t(self, key, path):
        pass

    def bn(self, key, path):
        pass

    def norm(self, kind, key, prefix, i):
        pass


def conv_paths(cfg: Config) -> dict[str, tuple[str, ...]]:
    """Port module name -> flax module path of every trunk and head conv."""
    w = _ConvPaths()
    resnet_state(w, cfg.backbone.depth, "backbone", ("backbone",))
    head_state(w, cfg.head.num_layers, cfg.head.norm, "rot_head_net",
               ("dense_head",))
    return w.paths


def load_quant(model, quant: dict) -> None:
    """Copy a flax ``quant`` collection (numpy leaves) into the static
    ``Int8Conv.act_amax`` buffers of ``model`` (an ``RDPN``). Raises
    ValueError naming the leaves it lacks."""
    from ..models.quant import static_convs

    paths = conv_paths(model.cfg)
    tree = _Tree({}, {})
    tree.trees["quant"] = quant or {}
    values = {}
    for name, m in static_convs(model).items():
        v = tree.get("quant", paths[name] + ("act_amax",))
        if v is not None:
            values[name] = (m, torch.from_numpy(np.array(v, np.float32)))
    if tree.missing:
        raise ValueError(f"quant tree does not cover the model's static "
                         f"int8 convs — missing {sorted(tree.missing)[:5]}")
    with torch.no_grad():
        for m, v in values.values():
            m.act_amax.copy_(v.reshape(m.act_amax.shape))


def quant_tree(model) -> dict:
    """The flax ``quant`` collection of ``model``'s static ``Int8Conv``
    absmax buffers, as numpy."""
    from ..models.quant import static_convs

    paths = conv_paths(model.cfg)
    out: dict = {}
    for name, m in static_convs(model).items():
        node = out
        for k in paths[name]:
            node = node.setdefault(k, {})
        node["act_amax"] = m.act_amax.detach().cpu().numpy()
    return out
