"""``python -m rdpn6d_tpu_torch.tools.eval_split`` against the JAX
package's ``tools/eval_split.py`` on ``tests/test_torch_tools.py``'s tiny
LM split and weights (an orbax step on the JAX side, the port's
checkpoint of the same variables on the other): the same JSON metric
dict (per-object tables and MEAN equal, 6 instances), the CSV's identity
columns equal, and its poses within bf16's reach, since both tools
evaluate in bf16: R within 5e-2 (measured 2.2e-2), t within 1e-2 of |t|
(measured 3.7e-3). ``test_torch_eval_runner.py`` holds the same poses in
float32 to 1e-4.
"""

import json

import numpy as np

from rdpn6d_tpu_torch.tools import eval_split
from tests.test_torch_eval_runner import (  # noqa: F401  (fixtures)
    OPTS,
    _read_csv,
    tree,
    weights,
)
from tests.test_torch_tools import (  # noqa: F401  (fixtures)
    _configs,
    _few_threads,
    _jax_tool,
    orbax_ckpt,
    roots,
)


def test_eval_split_matches_jax(roots, weights, orbax_ckpt, tmp_path,
                                monkeypatch):
    cfgs = _configs(tmp_path)
    common = ["--split", "two_obj_test", "--batch-size", "2", "--opts",
              *OPTS, f'train.output_dir="{tmp_path}"']
    _jax_tool("eval_split", ["--config-file", cfgs["jax"], "--ckpt-dir",
                             orbax_ckpt, "--csv", str(tmp_path / "j.csv"),
                             "--json", str(tmp_path / "j.json"), *common],
              monkeypatch)
    eval_split.main(["--config-file", cfgs["port"], "--ckpt-dir",
                     weights[2], "--csv", str(tmp_path / "t.csv"),
                     "--json", str(tmp_path / "t.json"), "--device", "cpu",
                     *common])
    j = json.loads((tmp_path / "j.json").read_text())
    t = json.loads((tmp_path / "t.json").read_text())
    assert set(t) == set(j)
    assert t["per_obj"] == j["per_obj"] and t["mean"] == j["mean"]
    assert t["stats"]["n_rois"] == j["stats"]["n_rois"] == 6
    j_id, j_R, j_t = _read_csv(tmp_path / "j.csv")
    t_id, t_R, t_t = _read_csv(tmp_path / "t.csv")
    assert t_id == j_id
    assert np.abs(t_R - j_R).max() <= 5e-2
    assert (np.linalg.norm(t_t - j_t, axis=1)
            <= 1e-2 * np.linalg.norm(j_t, axis=1)).all()
