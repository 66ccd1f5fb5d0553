"""The port stands alone: importing it pulls in neither jax nor the JAX
package, and no source of the port, of ``chip_smoke.py`` or of the
data-parallel tests' rank functions imports them, nor OpenCV or Pillow
(the GPU machine has neither; the port reads PNG itself). Importing the
port pulls in no matplotlib either (absent there too: ``utils/vis``'s
``grid_show`` imports it when called)."""

import ast
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "rdpn6d_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "rdpn6d_tpu", "cv2",
             "PIL")
NOT_AT_IMPORT = FORBIDDEN + ("matplotlib",)
# the trained-model tools and the bench_* tools; each but the two
# host-only renderers takes --device
NEW_TOOLS = ("make_mini_bop", "gen_xyz_crop", "overfit_synth",
             "int8_gate_sweep", "rehearse_protocol", "train_so_family",
             "bench_score_scale", "bench_input", "bench_cli_step",
             "bench_int8", "bench_bn", "bench_train", "bench_layout")
HOST_ONLY = ("make_mini_bop", "gen_xyz_crop")


def _port_modules():
    mods = []
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod.removesuffix(".__init__"))
    return mods


def test_import_pulls_no_jax():
    mods = _port_modules()
    assert {"rdpn6d_tpu_torch.ops.min_dist", "rdpn6d_tpu_torch.data.sampler",
            "rdpn6d_tpu_torch.data.device_cache",
            "rdpn6d_tpu_torch.engine.writers",
            "rdpn6d_tpu_torch.utils.pretrained",
            "rdpn6d_tpu_torch.data.augment", "rdpn6d_tpu_torch.data.jpeg",
            "rdpn6d_tpu_torch.data.image", "rdpn6d_tpu_torch.data.tif",
            "rdpn6d_tpu_torch.data.custom",
            "rdpn6d_tpu_torch.configs.lmo",
            "rdpn6d_tpu_torch.configs.base", "rdpn6d_tpu_torch.configs.ycbv",
            "rdpn6d_tpu_torch.configs.tless", "rdpn6d_tpu_torch.configs.tudl",
            "rdpn6d_tpu_torch.configs.hb", "rdpn6d_tpu_torch.configs.icbin",
            "rdpn6d_tpu_torch.configs.itodd", "rdpn6d_tpu_torch.configs.mp6d",
            "rdpn6d_tpu_torch.configs.mini", "rdpn6d_tpu_torch.configs.so",
            "rdpn6d_tpu_torch.ops.rasterizer",
            "rdpn6d_tpu_torch.ops.surface_labels",
            "rdpn6d_tpu_torch.ops.int8_conv",
            "rdpn6d_tpu_torch.ops.roi_crop",
            "rdpn6d_tpu_torch.models.quant",
            "rdpn6d_tpu_torch.parallel.mesh",
            "rdpn6d_tpu_torch.ops.ransac_kabsch",
            "rdpn6d_tpu_torch.geometry.se3",
            "rdpn6d_tpu_torch.models.point_pnp",
            "rdpn6d_tpu_torch.solver.projection",
            "rdpn6d_tpu_torch.solver.optax_rules",
            "rdpn6d_tpu_torch.ops.pnp_host",
            "rdpn6d_tpu_torch.ops.view_sampler",
            "rdpn6d_tpu_torch.utils.mask", "rdpn6d_tpu_torch.utils.vis",
            "rdpn6d_tpu_torch.utils.profiling",
            "rdpn6d_tpu_torch.tools.score_csv",
            "rdpn6d_tpu_torch.tools.convert_checkpoint",
            *(f"rdpn6d_tpu_torch.tools.{t}" for t in NEW_TOOLS)} \
        <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{NOT_AT_IMPORT!r})\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "profile_step.py")
    yield os.path.join(ROOT, "time_min_dist2.py")
    yield os.path.join(ROOT, "time_int8.py")
    yield os.path.join(ROOT, "time_labels.py")
    yield os.path.join(ROOT, "time_crop.py")
    yield os.path.join(ROOT, "time_ransac.py")
    yield os.path.join(ROOT, "ransac_conditioning.py")
    # the data-parallel tests' rank functions: a spawned rank must not
    # load jax
    yield os.path.join(ROOT, "tests", "torch_dist_workers.py")


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_no_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names = [str(node.args[0].value)]
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, (path, n)


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_loads_no_jax_package_file(path):
    """The port builds and loads its own host library: no source names the
    JAX package's rasterizer directory or its checked-in library."""
    with open(path) as f:
        text = f.read()
    for needle in ("librasterizer", "csrc/rasterizer/"):
        assert needle not in text, (path, needle)


@pytest.mark.parametrize("tool", NEW_TOOLS)
def test_tool_runs_as_a_module_without_jax(tool):
    """``python -m rdpn6d_tpu_torch.tools.<tool> --help`` in a process where
    importing any forbidden package fails: it exits 0, lists the JAX
    tool's flags (and ``--device`` where the tool computes on one) and
    loaded none of them."""
    code = (
        "import runpy, sys\n"
        f"for m in {FORBIDDEN!r}:\n"
        "    sys.modules[m] = None\n"
        f"sys.argv = [{tool!r}, '--help']\n"
        "try:\n"
        f"    runpy.run_module('rdpn6d_tpu_torch.tools.{tool}', "
        "run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code in (0, None), e.code\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(os.path.join(ROOT, "tools", f"{tool}.py")) as f:
        flags = set(re.findall(r'add_argument\("(--[a-z0-9-]+)"', f.read()))
    flags.discard("--platform")     # the JAX tool's; the port's --device
    assert flags and all(fl in proc.stdout for fl in flags), proc.stdout
    assert ("--device" in proc.stdout) == (tool not in HOST_ONLY)
