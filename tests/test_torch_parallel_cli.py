"""``scripts/train_torch.py --num_devices 2`` and ``scripts/eval_torch.py
--num_devices 2`` on the CPU: one command each, the script starting its
two gloo ranks itself (``cli.start_ranks``), against the same commands
run as one process in the pytest process.  Full widths at 32x32 (the
scripts have no width flags; five halvings reach 1x1), global batch 4,
one step, two eval images.

- Stage 1 under FSDP: the checkpoint rank 0 writes loads into one
  device's net and holds the one-process run's weights (rtol 5e-4 / atol
  1e-6, tests/test_train.py's data-parallel bound), and the step lines
  come from rank 0 alone.
- Data-parallel eval of that checkpoint's D-net: the one-process table
  to its printed 4 decimals, a1-a3 within one pixel of the sparsest
  image (tests/test_torch_evaluate.py's bound).
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gdn_tpu_torch.checkpoint import latest_step, load_params
from gdn_tpu_torch.data.synthetic import SyntheticEvalDataset
from gdn_tpu_torch.metrics import METRIC_NAMES, crop_mask

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = ["--dataset", "synthetic", "--device", "cpu", "--dtype", "float32",
          "--height", "32", "--width", "32"]
TRAIN = ["--mode", "DtoD", "--batch_size", "4", "--epochs", "1", "--steps_per_epoch", "1",
         "--log_every", "1"]
EVAL = ["--stage", "1", "--eval_batch", "2", "--max_images", "2"]


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _command(name, argv):
    env = dict(os.environ, OMP_NUM_THREADS="2", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(REPO, "scripts", f"{name}.py"), *argv],
                         capture_output=True, text=True, timeout=240, env=env, cwd=REPO)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


def _table(stdout):
    """The ``name=value`` line eval_torch.py prints last."""
    line = [ln for ln in stdout.splitlines() if ln.startswith("abs_rel=")][-1]
    return {k: float(v) for k, v in (kv.split("=") for kv in line.split())}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_cli")
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        dp, one = str(tmp / "dp"), str(tmp / "one")
        train_out = _command("train_torch", COMMON + TRAIN + ["--num_devices", "2", "--fsdp",
                                                             "--ckpt_dir", dp])
        eval_out = _command("eval_torch", COMMON + EVAL + ["--num_devices", "2",
                                                          "--ckpt_dir", dp])
        _script("train_torch").main(COMMON + TRAIN + ["--ckpt_dir", one])
        want = _script("eval_torch").main(COMMON + EVAL + ["--ckpt_dir", one])
    finally:
        torch.set_num_threads(old)
    return dict(dp=dp, one=one, train_out=train_out, eval_out=eval_out, eval_one=want)


def test_train_script_starts_two_ranks_and_logs_on_rank_0(runs):
    out = runs["train_out"]
    assert out.count("backend gloo (ranks on the CPU)") == 2
    assert sum(ln.startswith("[stage1] step=1") for ln in out.splitlines()) == 1


def test_fsdp_script_checkpoint_is_one_devices(runs):
    d = os.path.join(runs["dp"], "stage1")
    assert latest_step(d) == 1
    got = load_params(d)
    want = load_params(os.path.join(runs["one"], "stage1"))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=5e-4, atol=1e-6,
                                   err_msg=k)


def _one_pixel():
    """The share of one pixel in the sparsest scored image (GT valid
    within the cap, inside the garg crop)."""
    counts = [((s["gt"][0] > 1e-3) & (s["gt"][0] < 80.0) & crop_mask(32, 32, "garg")).sum()
              for s in SyntheticEvalDataset(2, 32, 32)]
    return 1.0 / min(counts)


def test_dp_eval_script_matches_one_process(runs):
    """To the printed precision (4 decimals), a1-a3 within one pixel."""
    got = _table(runs["eval_out"])
    want = runs["eval_one"]
    for k in METRIC_NAMES:
        atol = 1e-4 + (_one_pixel() if k in ("a1", "a2", "a3") else 0.0)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=atol, err_msg=k)
