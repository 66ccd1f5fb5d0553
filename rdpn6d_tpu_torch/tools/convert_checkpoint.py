"""Convert released weights to the port's checkpoint directory.

Counterpart of ``tools/convert_checkpoint.py``, which turns a reference
(torch) RDPN/GDRN checkpoint into flax params. The port's module tree has
the reference checkpoint's key names (``backbone.*``,
``backbone.spatial_net.*``, ``rot_head_net.features.*``, ``pnp_net.*``),
so a reference ``.pth`` loads as it is, its ``state_dict``/``model``
wrapper and ``module.``/``model.`` prefixes stripped; a JAX
``params.pkl`` goes through ``utils/flax_params.checkpoint_from_params_pkl``.
Either way the result is ``<out>/<step>/state.pt``, the directory
``Predictor(ckpt_dir=...)`` and ``main --eval-only`` read (with
``train.output_dir`` at its parent when ``<out>`` is ``.../ckpt``).

Usage:
  python -m rdpn6d_tpu_torch.tools.convert_checkpoint --pth model.pth \\
      --out output/lm13/ckpt [--depth 34] \\
      [--config-file rdpn6d_tpu_torch/configs/lm13.py] [--opts ...]
  python -m rdpn6d_tpu_torch.tools.convert_checkpoint \\
      --params-pkl params.pkl --out output/lm13/ckpt
"""

from __future__ import annotations

import argparse
import os

# a torch BatchNorm's counter, which some saved checkpoints leave out
_OPTIONAL = ("num_batches_tracked",)


def reference_state_dict(path: str) -> dict:
    """A reference ``.pth``'s tensors under the port's key names."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict", "model"):
        if isinstance(sd, dict) and key in sd:
            sd = sd[key]
    return {k.removeprefix("module.").removeprefix("model."): v
            for k, v in sd.items() if isinstance(v, torch.Tensor)}


def main(argv=None):
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--pth", help="a reference RDPN6D/GDRN checkpoint")
    src.add_argument("--params-pkl", help="a JAX package params pickle")
    p.add_argument("--out", required=True,
                   help="the checkpoint directory to write")
    p.add_argument("--depth", type=int, default=34)
    p.add_argument("--config-file",
                   default=os.path.join(here, "configs", "lm13.py"))
    p.add_argument("--opts", nargs="*", default=[])
    p.add_argument("--step", type=int, default=0)
    args = p.parse_args(argv)

    import torch

    from ..config import load_config
    from ..engine.checkpoint import STATE_FILE
    from ..utils.flax_params import checkpoint_from_params_pkl

    cfg = load_config(args.config_file,
                      [f"backbone.depth={args.depth}"] + args.opts)
    if args.params_pkl:
        step_dir = checkpoint_from_params_pkl(cfg, args.params_pkl,
                                              args.out, step=args.step)
    else:
        from ..engine.checkpoint import CheckpointManager
        from ..models import RDPN
        from ..parallel import create_train_state

        model = RDPN(cfg)
        sd = reference_state_dict(args.pth)
        want = model.state_dict()
        missing = [k for k in want if k not in sd
                   and not k.endswith(_OPTIONAL)]
        extra = [k for k in sd if k not in want]
        if missing or extra:
            raise SystemExit(
                f"{args.pth} does not fit the model of {args.config_file} "
                f"(backbone.depth={args.depth}): {len(missing)} missing "
                f"(e.g. {missing[:3]}), {len(extra)} unexpected "
                f"(e.g. {extra[:3]})")
        model.load_state_dict({**want, **sd})
        mgr = CheckpointManager(args.out)
        mgr.save(args.step, create_train_state(cfg, model))
        step_dir = os.path.join(mgr.directory, str(args.step))
    saved = torch.load(os.path.join(step_dir, STATE_FILE),
                       map_location="cpu", weights_only=True)["model"]
    n = sum(v.numel() for k, v in saved.items()
            if not k.endswith(("running_mean", "running_var") + _OPTIONAL))
    print(f"converted {n / 1e6:.1f}M params -> {step_dir}")
    return step_dir


if __name__ == "__main__":
    main()
