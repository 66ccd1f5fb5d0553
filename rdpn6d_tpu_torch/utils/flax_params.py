"""The weight carrier: a flax ``params``/``batch_stats`` tree, as numpy,
to the port's ``state_dict``.

The JAX package saves served weights as a pickle of numpy trees
(``engine/predictor.py``'s ``params_pkl``), named by flax's auto-naming:
``backbone/{Conv_0,BatchNorm_0,BasicBlock_i/...}``,
``spatial_net/{Conv_i,BatchNorm_i}``,
``dense_head/{ConvTranspose_0,Conv_j,BatchNorm_j}`` and
``pnp_net/{Conv_j,GroupNorm_j,Dense_j}``. The port's keys are the reference
checkpoint's (``backbone.*``, ``backbone.spatial_net.*``,
``rot_head_net.features.*``, ``pnp_net.*``), the layout that
``rdpn6d_tpu/utils/torch_convert.convert_rdpn_checkpoint`` reads back.

Layouts: conv kernels HWIO -> OIHW; the transposed conv's
[kh, kw, out, in] -> [in, out, kh, kw]; dense kernels [in, out] -> [out, in];
``fc1``'s input axis from flax's NHWC flatten order to torch's NCHW one,
over the PnP net's own output map (derived from the config, not assumed
8x8).
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
        return np.asarray(node, np.float32)


class _Writer:
    def __init__(self, tree: _Tree):
        self.t = tree
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


def pnp_state(w: _Writer, num_layers: int, norm: str, featdim: int,
              out_res: int, prefix: str, path: tuple) -> None:
    for j in range(num_layers):
        w.conv(f"{prefix}.features.{3 * j}", path + (f"Conv_{j}",))
        w.norm(norm, f"{prefix}.features.{3 * j + 1}", path, j)

    def nhwc_to_nchw(wt):  # [out, H*W*C] in flax order -> torch order
        if wt.shape[1] != out_res * out_res * featdim:
            raise ValueError(
                f"{prefix}.fc1: {wt.shape[1]} inputs, expected "
                f"{out_res}x{out_res}x{featdim} from the config")
        return wt.reshape(-1, out_res, out_res, featdim).transpose(
            0, 3, 1, 2).reshape(wt.shape)

    w.dense(f"{prefix}.fc1", path + ("Dense_0",), nhwc_to_nchw)
    for j, fc in enumerate(["fc2", "fc_r", "fc_t"], start=1):
        w.dense(f"{prefix}.{fc}", path + (f"Dense_{j}",))


def pnp_out_res(cfg: Config) -> int:
    from ..models.rdpn import head_out_res

    res = head_out_res(cfg)
    for i in range(cfg.pnp.num_layers):
        if i < 3:
            res = (res - 1) // 2 + 1
    return res


def carry(fill, params: dict, batch_stats: dict | None = None
          ) -> dict[str, torch.Tensor]:
    """Run ``fill(writer)`` (which names the leaves to map, e.g.
    ``lambda w: pnp_state(w, 3, "GN", 128, 8, "", ())`` for one
    submodule) over a flax tree and return the torch tensors.

    Raises ValueError naming the missing leaves when the tree does not
    cover what ``fill`` asks for: a partial tree would serve random-init
    weights."""
    tree = _Tree(params, batch_stats or {})
    w = _Writer(tree)
    fill(w)
    if tree.missing:
        some = sorted(tree.missing)[:5]
        raise ValueError(
            f"flax tree does not cover the model — {len(tree.missing)} "
            f"missing leaves (e.g. {some}); refusing to mix random-init "
            "values into served weights")
    return {k: torch.from_numpy(np.array(v)) for k, v in w.sd.items()}


def state_dict_from_flax(cfg: Config, params: dict,
                         batch_stats: dict | None = None,
                         ) -> dict[str, torch.Tensor]:
    """Map a flax RDPN tree (numpy leaves) to the port's ``state_dict``."""
    def fill(w: _Writer) -> None:
        resnet_state(w, cfg.backbone.depth, "backbone", ("backbone",))
        pointnet_state(w, "backbone.spatial_net", ("spatial_net",))
        head_state(w, cfg.head.num_layers, cfg.head.norm, "rot_head_net",
                   ("dense_head",))
        pnp_state(w, cfg.pnp.num_layers, cfg.pnp.norm, cfg.pnp.featdim,
                  pnp_out_res(cfg), "pnp_net", ("pnp_net",))

    return carry(fill, params, batch_stats)
