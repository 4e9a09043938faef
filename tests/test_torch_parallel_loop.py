"""The port's loops, checkpoints, eval and data over two gloo ranks on
the CPU, against the JAX package and against one process.

One spawn for the file (``torch_parallel_ranks.loop_scenarios``):

- a checkpoint written by a 2-rank FSDP run is the file a one-device run
  writes, loads into one device, whose checkpoint loads back into a
  2-rank data-parallel run, and the three legs continue one device's
  unbroken trajectory (rtol 5e-4 / atol 1e-6, tests/test_train.py's
  data-parallel bound: the legs sum gradients in another order);
- SIGTERM on one rank stops both after the same step;
- data-parallel eval against the JAX ``Evaluator(mesh=create_mesh(2))``
  (an analytic forward: the protocol is under test) at 1e-5, a1-a3
  within one pixel of the sparsest image (tests/test_torch_evaluate.py's
  bound), host-fed and device-cached, and with the G-net against one
  process, predictions included, at 1e-5 (a rank's convolutions run on
  half the batch);
- ``train_stage2`` with validation and in-training eval against one
  process;
- the augmented pipeline (host-fed and through the device cache) gives
  each rank its rows of one device's batch, exactly, and the sharded
  device cache's batches are the JAX ``ShardedDeviceDataset``'s, bit
  for bit.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gdn_tpu import config as jcfg
from gdn_tpu import evaluate as JE
from gdn_tpu import metrics as JM
from gdn_tpu.data.device_cache import ShardedDeviceDataset as JSharded
from gdn_tpu.data.kitti import KittiTrainDataset as JKitti
from gdn_tpu.parallel import mesh as jmesh
from gdn_tpu_torch.checkpoint import latest_step, save_checkpoint
from gdn_tpu_torch.data.device_cache import DeviceResidentDataset, ShardedDeviceDataset
from gdn_tpu_torch.data.kitti import KittiTrainDataset
from gdn_tpu_torch.data.pipeline import make_train_pipeline
from gdn_tpu_torch.evaluate import evaluate
from gdn_tpu_torch.parallel.multihost import run_ranks
from gdn_tpu_torch.train import steps as tsteps
from gdn_tpu_torch.train.loop import train_stage2
from gdn_tpu_torch.train.state import TrainState
from gdn_tpu_torch.train.steps import make_eval_forward
from gdn_tpu_torch.utils.logging import MetricLogger

import torch_parallel_ranks as R

GRADS = dict(rtol=5e-4, atol=1e-6)
TOL = dict(atol=1e-5, rtol=1e-5)
CAP = 80.0


def _samples(seed, n, gt_shapes):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        rgb = rng.uniform(0, 1, (1, *R.HW, 3)).astype(np.float32)
        gt = rng.uniform(0, CAP * 1.3, (1, *gt_shapes[i % len(gt_shapes)])).astype(np.float32)
        gt[rng.uniform(size=gt.shape) < 0.15] = 0.0
        out.append({"rgb": rgb, "gt": gt})
    return out


def _corpus(root):
    """8 RGB / 16-bit depth PNG pairs at 40x60, sparse depth."""
    rng = np.random.default_rng(0)
    os.makedirs(root / "img")
    lines = []
    for i in range(8):
        Image.fromarray(rng.integers(0, 256, (40, 60, 3), np.uint8)).save(root / "img" / f"{i}.png")
        d = rng.uniform(0, 90, (40, 60))
        d[rng.uniform(size=d.shape) < 0.6] = 0.0
        Image.fromarray(np.round(d * 256).astype(np.uint16)).save(root / "img" / f"{i}_d.png")
        lines.append(f"img/{i}.png img/{i}_d.png")
    (root / "train.txt").write_text("\n".join(lines) + "\n")
    return str(root)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Tiny nets: one thread here and in each rank (OMP_NUM_THREADS
    reaches the spawned ranks), where the default would oversubscribe
    the host's cores among pytest's workers."""
    old, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "2"  # run_ranks gives each of 2 ranks half
    yield
    torch.set_num_threads(old)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = env


@pytest.fixture(scope="module")
def run(tmp_path_factory, _few_threads):
    tmp = tmp_path_factory.mktemp("parallel_loop")
    sd = R.weights()
    tb = [{k: torch.from_numpy(v) for k, v in b.items()} for b in R.batches(6, seed=5)]
    samples = {"pad": _samples(3, 5, [(93, 311)]),
               "mixed": _samples(4, 7, [(93, 311), (64, 208), (75, 100)])}
    root = _corpus(tmp / "kitti")
    inp = str(tmp / "inputs.pt")
    torch.save({"sd": sd, "batches": tb, "samples": samples, "root": root}, inp)
    run_ranks(R.loop_scenarios, 2, (inp, str(tmp)), device_type="cpu", timeout=180)
    return dict(dir=str(tmp), sd=sd, batches=tb, samples=samples, root=root)


def _npz(run, name):
    with np.load(os.path.join(run["dir"], f"{name}.npz")) as z:
        return dict(z)


def _ckpt(path):
    return torch.load(path, map_location="cpu", weights_only=True)


@pytest.fixture(scope="module")
def one_device(run, tmp_path_factory):
    """Six stage-1 steps of one process from the same weights, with a
    checkpoint after the second: (its directory, the final state_dict)."""
    tmp = tmp_path_factory.mktemp("one_device")
    cfg = R.loop_config(str(tmp), "one", ema_decay=0.9)
    state = TrainState(R.nets(run["sd"], 1, cfg)[0], cfg.train, 2)
    step = tsteps.make_stage1_step(cfg)
    for b in run["batches"]:
        state, _ = step(state, b)
        if state.step == 2:
            save_checkpoint(str(tmp / "one"), state.step, state)
    return str(tmp / "one"), state.state_dict()


def _flat(obj, prefix=""):
    """(key path, tensor or value) pairs of a nested checkpoint payload."""
    if isinstance(obj, dict):
        for k in sorted(obj, key=str):
            yield from _flat(obj[k], f"{prefix}/{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, obj


def test_fsdp_checkpoint_is_a_one_device_checkpoint(run, one_device):
    """The 2-rank FSDP file: the same keys, shapes, dtypes and layout as
    one device's after the same two steps, and the same values."""
    want = dict(_flat(_ckpt(os.path.join(one_device[0], "2.pt"))))
    got = dict(_flat(_ckpt(os.path.join(run["dir"], "ck_a", "stage1", "2.pt"))))
    assert set(got) - {"/loader/step"} == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, torch.Tensor):
            assert (g.shape, g.dtype) == (w.shape, w.dtype), k
            np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=k, **GRADS)
        else:
            assert g == w, k


def test_checkpoint_round_trip_continues_the_trajectory(run, one_device):
    """FSDP (2 ranks) -> one device -> data parallel (2 ranks), two steps
    each, against six steps of one device."""
    want = one_device[1]
    ck = os.path.join(run["dir"], "ck_c", "stage1")
    assert latest_step(ck) == 6
    got = _ckpt(os.path.join(ck, "6.pt"))
    assert (got["step"], got["updates"]) == (6, 6)
    for key in ("params", "ema"):
        for k, w in want[key].items():
            np.testing.assert_allclose(got[key][k].numpy(), w.numpy(), err_msg=k, **GRADS)
    for i, st in want["optimizer"]["state"].items():
        # the second moment squares the gradient: twice its relative error
        for k, tol in (("exp_avg", GRADS), ("exp_avg_sq", dict(rtol=1e-3, atol=1e-12))):
            np.testing.assert_allclose(got["optimizer"]["state"][i][k].numpy(),
                                       st[k].numpy(), err_msg=f"{i}/{k}", **tol)


def test_preemption_on_one_rank_stops_every_rank_at_the_same_step(run):
    steps = [int(_npz(run, f"preempt.rank{r}")["step"]) for r in (0, 1)]
    assert steps == [3, 3]
    assert latest_step(os.path.join(run["dir"], "ck_p", "stage1")) == 3


def _one_pixel(samples):
    counts = [(((s["gt"][0] > 1e-3) & (s["gt"][0] < CAP))
               & JM.crop_mask(*s["gt"].shape[1:], "garg")).sum() for s in samples]
    return 1.0 / min(counts)


def _j_forward(params, rgb):
    return 2.0 + 60.0 * jax.nn.sigmoid(3.0 * jnp.mean(rgb, axis=-1, keepdims=True) - 1.0)


@pytest.mark.parametrize("feed", ["host", "cached"])
@pytest.mark.parametrize("split", ["pad", "mixed"])
def test_dp_eval_matches_jax_evaluator_on_a_mesh(run, split, feed):
    jc = jcfg.Config(model=jcfg.ModelConfig(image_size=R.HW, dtype="float32"),
                     eval=jcfg.EvalConfig(batch_size=2))
    samples = run["samples"][split]
    want = JE.Evaluator(jc, _j_forward, mesh=jmesh.create_mesh(2)).run(
        {}, iter(samples), verbose=False)
    one_pixel = _one_pixel(samples)
    for r in (0, 1):
        got = _npz(run, f"eval.rank{r}")
        for k in JM.METRIC_NAMES:
            atol = max(TOL["atol"], one_pixel) if k in ("a1", "a2", "a3") else TOL["atol"]
            np.testing.assert_allclose(got[f"{split}/{feed}/{k}"], want[k], atol=atol,
                                       rtol=TOL["rtol"], err_msg=f"rank {r} {k}")


def test_dp_eval_of_the_gnet_matches_one_process(run, tmp_path):
    cfg = R.loop_config(str(tmp_path), "unused")
    g = R.nets(run["sd"], 2, cfg)[0]
    want = evaluate(cfg, make_eval_forward(cfg, g), run["samples"]["mixed"], verbose=False,
                    device="cpu", save_preds=str(tmp_path / "preds"))
    for r in (0, 1):
        got = _npz(run, f"eval.rank{r}")
        for k in JM.METRIC_NAMES:
            np.testing.assert_allclose(got[f"gnet/{k}"], want[k], **TOL, err_msg=k)
    names = sorted(os.listdir(tmp_path / "preds"))
    assert names == sorted(os.listdir(os.path.join(run["dir"], "preds_dp")))
    for n in names:
        np.testing.assert_allclose(np.load(os.path.join(run["dir"], "preds_dp", n)),
                                   np.load(tmp_path / "preds" / n), **TOL)


def _log(path):
    rows = [json.loads(line) for line in open(path)]
    return {k: v for row in rows for k, v in row.items()
            if k.startswith(("val_", "eval_")) and not k.endswith("fps")}


def test_stage2_validation_and_in_training_eval_under_dp(run, tmp_path):
    cfg = R.loop_config(str(tmp_path), "ck_s2")
    logger = MetricLogger(prefix="stage2", jsonl_path=str(tmp_path / "stage2.jsonl"))
    train_stage2(cfg, iter(run["batches"][:2]), run["sd"]["d"], epochs=1, logger=logger,
                 val_iter=run["batches"][2:3], val_steps=1,
                 eval_dataset=lambda: run["samples"]["pad"], eval_every=1, device="cpu")
    logger.close()
    want = _log(tmp_path / "stage2.jsonl")
    got = _log(os.path.join(run["dir"], "stage2.jsonl"))
    assert {"val_total", "val_recon", "eval_rmse", "eval_a1"} <= set(want)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-6, err_msg=k)
    assert latest_step(os.path.join(run["dir"], "ck_s2", "stage2_best")) == 2


def _loader(run, seed=0, **kw):
    cfg = R.pipeline_config()
    return KittiTrainDataset(run["root"], "train.txt", cfg.model.image_size, 4, seed=seed,
                             max_depth=cfg.model.max_depth, **kw)


@pytest.mark.parametrize("source", ["host", "cached"])
def test_pipeline_gives_each_rank_its_rows_of_one_devices_batch(run, source):
    """The augmentation values are drawn for the global batch, so each
    rank's rows are cropped, flipped and jittered as on one device."""
    src = _loader(run) if source == "host" else DeviceResidentDataset(_loader(run), device="cpu")
    pipe = make_train_pipeline(R.pipeline_config(), src, device="cpu")
    want = [next(pipe) for _ in range(2)]
    for r in (0, 1):
        got = _npz(run, f"pipeline.rank{r}")
        for i, b in enumerate(want):
            for k, v in b.items():
                np.testing.assert_array_equal(got[f"{source}/{i}/{k}"],
                                              v[2 * r:2 * r + 2].numpy(), err_msg=f"{i}/{k}")


@pytest.mark.parametrize("skip", [0, 1])
def test_sharded_device_cache_matches_jax(run, skip):
    """The ranks' rows, concatenated in rank order, are the JAX
    ShardedDeviceDataset's global batches on a 2-device mesh, bit for
    bit (depth: the same uint16 counts, carried as int16)."""
    cfg = R.pipeline_config()
    jds = JSharded(JKitti(run["root"], "train.txt", cfg.model.image_size, batch_size=4,
                          loop=False, shuffle=True, seed=7, max_depth=cfg.model.max_depth),
                   jmesh.create_mesh(2))
    jds.seek(skip)
    want = [{k: np.asarray(v) for k, v in b.items()} for b in jds]
    ranks = [_npz(run, f"pipeline.rank{r}") for r in (0, 1)]
    tag = "sharded" if skip == 0 else "sharded_seek"
    n = len({k.split("/")[1] for k in ranks[0] if k.startswith(tag + "/")})
    assert n == len(want) > 0
    for i, w in enumerate(want):
        rgb = np.concatenate([z[f"{tag}/{i}/rgb"] for z in ranks])
        depth = np.concatenate([z[f"{tag}/{i}/depth"] for z in ranks]).view(np.uint16)
        np.testing.assert_array_equal(rgb, w["rgb"])
        np.testing.assert_array_equal(depth, w["depth"])


@pytest.mark.parametrize("loop", [False, True])
def test_sharded_index_stream_matches_jax(run, loop):
    cfg = R.pipeline_config()
    kw = dict(loop=loop, shuffle=True, seed=11)
    jds = JSharded(JKitti(run["root"], "train.txt", cfg.model.image_size, batch_size=4,
                          max_depth=cfg.model.max_depth, **kw), jmesh.create_mesh(2))
    tds = ShardedDeviceDataset(_loader(run, **kw), R.StubMesh(2), device="cpu")
    take = 7 if loop else None
    want = [i for _, i in zip(range(take or 10**6), jds._index_iter())]
    got = [i for _, i in zip(range(take or 10**6), tds._index_iter())]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
