"""Training of the PyTorch port against the JAX package.

- The optimizer pieces (LR schedules, clipped Adam / AdamW, EMA) against
  optax on the same numpy parameters and gradients.
- Training parity, in the pattern of tests/test_parity_training.py:
  stage 1, the decoder transfer, then stage 2, 10 steps each, the port's
  ``make_stage{1,2}_step`` against the JAX package's on the same
  ``synthetic_batch`` arrays from the same flax-initialized weights,
  fp32 on the CPU, every loss term held to atol 1e-4 / rtol 1e-3 (that
  file's bound: both sides round independently; a real divergence moves
  the losses at the 1e-1 level at once).
- The loops, the checkpoints they write, the data source, the logger
  and ``scripts/train_torch.py`` at tiny sizes on the CPU.
"""

import importlib.util
import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch

from gdn_tpu import config as jcfg
from gdn_tpu.checkpoint import transfer_stage1_decoder as j_transfer
from gdn_tpu.data.synthetic import synthetic_batch as j_batch
from gdn_tpu.models import DtoDNet as JDtoD, RtoDNet as JRtoD
from gdn_tpu.train import state as jstate
from gdn_tpu.train import steps as jsteps
from gdn_tpu.utils.logging import MetricLogger as JLogger
from gdn_tpu_torch import config as tcfg
from gdn_tpu_torch.checkpoint import (
    latest_step, load_params, params_from_flax, transfer_stage1_decoder,
)
from gdn_tpu_torch.data.synthetic import SyntheticDataset
from gdn_tpu_torch.models import DtoDNet, RtoDNet
from gdn_tpu_torch.serving import BatchedPredictor
from gdn_tpu_torch.train import state as tstate
from gdn_tpu_torch.train import steps as tsteps
from gdn_tpu_torch.train.loop import train_stage1, train_stage2
from gdn_tpu_torch.utils.logging import MetricLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_STEPS = 10
HW = (16, 32)
SMALL = dict(image_size=HW, enc_channels=(8, 16), dec_channels=(16, 8),
             dtype="float32", use_pallas_gn=True)
FUSED = dict(use_pallas_convgn_bt=True, use_pallas_convgn_s2=True,
             use_pallas_fusion_bt=True)
FUSION = dict(use_pallas_fusion=True)


# ------------------------------------------------------------- optimizer

@pytest.mark.parametrize("warmup", [0, 3])
@pytest.mark.parametrize("schedule", ["step", "cosine", "constant"])
def test_lr_schedule_matches_optax(schedule, warmup):
    kw = dict(lr=1e-3, schedule=schedule, decay_epochs=2, decay_gamma=0.5,
              epochs=4, warmup_steps=warmup)
    spe = 5
    want = jstate.lr_schedule(jcfg.TrainConfig(**kw), spe)
    got = tstate.lr_schedule(tcfg.TrainConfig(**kw), spe)
    ts = range(0, 3 * 2 * spe + 1)
    # rtol 1e-5: optax evaluates in float32, the port in float64
    np.testing.assert_allclose([got(t) for t in ts], [float(want(t)) for t in ts],
                               rtol=1e-5, atol=1e-12)


class _Params(torch.nn.Module):
    def __init__(self, arrays):
        super().__init__()
        for k, v in arrays.items():
            setattr(self, k, torch.nn.Parameter(torch.from_numpy(v.copy())))


def _updates(kw, n=4, spe=2, seed=0):
    """n updates of optax (the JAX package's create_optimizer) and of the
    port's TrainState from the same params and gradients."""
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(4,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * 2).astype(np.float32)
              for k, v in params.items()} for _ in range(n)]
    tx = jstate.create_optimizer(jcfg.TrainConfig(**kw), spe)
    jp = {k: jax.numpy.asarray(v) for k, v in params.items()}
    opt = tx.init(jp)
    for g in grads:
        upd, opt = tx.update({k: jax.numpy.asarray(v) for k, v in g.items()}, opt, jp)
        jp = optax.apply_updates(jp, upd)
    net = _Params(params)
    st = tstate.TrainState(net, tcfg.TrainConfig(**kw), spe)
    for g in grads:
        for k, p in net.named_parameters():
            p.grad = torch.from_numpy(g[k])
        st.apply_gradients()
    assert st.step == n
    return {k: np.asarray(v) for k, v in jp.items()}, {
        k: p.detach().numpy() for k, p in net.named_parameters()}, st


@pytest.mark.parametrize("kw", [
    dict(lr=1e-2, grad_clip=0.5, warmup_steps=2, decay_epochs=1),  # clip active
    dict(lr=1e-2, grad_clip=100.0, weight_decay=0.01, schedule="cosine",
         epochs=2),  # AdamW, clip inactive
], ids=["adam_clipped", "adamw_unclipped"])
def test_optimizer_update_matches_optax(kw):
    want, got, _ = _updates(kw)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7)


def test_clip_by_global_norm_rule():
    p = torch.nn.Parameter(torch.zeros(4))
    p.grad = torch.tensor([3.0, 4.0, 0.0, 0.0])  # norm 5
    assert float(tstate.clip_by_global_norm_([p], 5.0)) == 5.0
    np.testing.assert_allclose(p.grad.numpy(), [3.0, 4.0, 0, 0], rtol=1e-6)
    p.grad = torch.tensor([3.0, 4.0, 0.0, 0.0])
    tstate.clip_by_global_norm_([p], 5.0001)  # below max_norm: untouched
    np.testing.assert_array_equal(p.grad.numpy(), [3.0, 4.0, 0, 0])
    tstate.clip_by_global_norm_([p], 1.0)
    np.testing.assert_allclose(p.grad.numpy(), [0.6, 0.8, 0, 0], rtol=1e-6)


def test_ema_update():
    kw = dict(lr=1e-2, ema_decay=0.9)
    rng = np.random.default_rng(3)
    init = {"w": rng.normal(size=(5,)).astype(np.float32)}
    net = _Params(init)
    st = tstate.TrainState(net, tcfg.TrainConfig(**kw), 10)
    ema = init["w"].astype(np.float64)
    for _ in range(3):
        net.w.grad = torch.from_numpy(rng.normal(size=(5,)).astype(np.float32))
        st.apply_gradients()
        ema = ema * 0.9 + net.w.detach().numpy().astype(np.float64) * 0.1
    np.testing.assert_allclose(st.ema["w"].numpy(), ema, rtol=1e-6)
    assert not st.ema["w"].requires_grad


# --------------------------------------------------------- training parity

def _cfgs(model=SMALL):
    train = dict(lr=1e-3, steps_per_epoch=N_STEPS, ckpt_dir="")
    data = dict(dataset="synthetic", batch_size=4)
    j = jcfg.Config(model=jcfg.ModelConfig(**model), train=jcfg.TrainConfig(**train),
                    data=jcfg.DataConfig(**data))
    t = tcfg.Config(model=tcfg.ModelConfig(**model), train=tcfg.TrainConfig(**train),
                    data=tcfg.DataConfig(**data))
    return j, t


def _batches(seed):
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(N_STEPS):
        key, sub = jax.random.split(key)
        out.append({k: np.asarray(v) for k, v in j_batch(sub, 4, *HW, 80.0).items()})
    return out


def _torch_batch(b):
    return {k: torch.from_numpy(v.copy()) for k, v in b.items()}


def _flax_sd(params):
    return params_from_flax(jax.tree_util.tree_map(np.asarray, params))


def _compare(jax_traj, port_traj):
    for t, (jt, pt) in enumerate(zip(jax_traj, port_traj)):
        assert set(jt) == set(pt)
        for k in jt:
            assert np.isfinite(pt[k]), (t, k)
            np.testing.assert_allclose(pt[k], jt[k], atol=1e-4, rtol=1e-3,
                                       err_msg=f"step {t} term {k}")


def _run_parity(model):
    """Stage 1, the decoder transfer, then stage 2, N_STEPS each, in the
    JAX package and in the port from the same weights and batches."""
    jc, tc = _cfgs(model)
    h, w = HW
    # stage 1
    js = jstate.create_state(JDtoD(cfg=jc.model), (1, h, w, 1), jc.train, N_STEPS)
    d_net = DtoDNet(tc.model)
    d_net.load_state_dict(_flax_sd(js.params), strict=True)
    ts = tstate.TrainState(d_net, tc.train, N_STEPS)
    jstep, tstep = jsteps.make_stage1_step(jc), tsteps.make_stage1_step(tc)
    s1 = ([], [])
    for b in _batches(7):
        js, jt = jstep(js, b)
        ts, tt = tstep(ts, _torch_batch(b))
        s1[0].append({k: float(v) for k, v in jt.items()})
        s1[1].append({k: float(v) for k, v in tt.items()})
    # transfer: each side moves its own trained decoder into the same
    # flax-initialized G-net
    gs = jstate.create_state(JRtoD(cfg=jc.model), (1, h, w, 3), jc.train, N_STEPS,
                             freeze_decoder=True)
    g_init = _flax_sd(gs.params)
    gs = gs.replace(params=j_transfer(gs.params, js.params))
    d_sd = {k: v.clone() for k, v in d_net.state_dict().items()}
    g_net = RtoDNet(tc.model)
    g_net.load_state_dict(transfer_stage1_decoder(g_init, d_sd), strict=True)
    g_dec = {k: v.clone() for k, v in g_net.decoder.state_dict().items()}
    d_net.requires_grad_(False)
    tg = tstate.TrainState(g_net, tc.train, N_STEPS, freeze_decoder=True)
    jstep2, tstep2 = jsteps.make_stage2_step(jc), tsteps.make_stage2_step(tc)
    s2 = ([], [])
    for b in _batches(11):
        gs, jt = jstep2(gs, js.params, b)
        tg, tt = tstep2(tg, d_net, _torch_batch(b))
        s2[0].append({k: float(v) for k, v in jt.items()})
        s2[1].append({k: float(v) for k, v in tt.items()})
    return dict(s1=s1, s2=s2, d_net=d_net, d_sd=d_sd, g_net=g_net, g_dec=g_dec,
                g_init=g_init)


@pytest.fixture(scope="module")
def parity():
    return _run_parity(SMALL)


@pytest.fixture(scope="module")
def parity_fused():
    """The same run with every 3x3 conv site on the fused
    conv3x3+GroupNorm+ELU route: in the port the kernels' plain versions
    inside their autograd Functions (analytic backward); in the JAX
    package, on the CPU, the XLA route of the same function."""
    return _run_parity(dict(SMALL, **FUSED))


def test_stage1_training_parity(parity):
    _compare(*parity["s1"])
    assert parity["s1"][1][-1]["total"] < parity["s1"][1][0]["total"]


def test_stage2_training_parity(parity):
    _compare(*parity["s2"])
    assert "latent" in parity["s2"][1][0]


def test_stage2_freezes_decoder_and_dnet(parity):
    for k, v in parity["g_net"].decoder.state_dict().items():
        assert torch.equal(v, parity["g_dec"][k]), k
    for k, v in parity["d_net"].state_dict().items():
        assert torch.equal(v, parity["d_sd"][k]), k
    moved = parity["g_net"].encoder.stem.Conv_0.kernel.detach()
    assert not torch.equal(moved, parity["g_init"]["encoder.stem.Conv_0.kernel"])


def test_stage1_training_parity_fused(parity_fused):
    _compare(*parity_fused["s1"])
    assert parity_fused["s1"][1][-1]["total"] < parity_fused["s1"][1][0]["total"]


def test_stage2_training_parity_fused(parity_fused):
    _compare(*parity_fused["s2"])
    assert "latent" in parity_fused["s2"][1][0]


def test_stage2_freezes_decoder_and_dnet_fused(parity_fused):
    p = parity_fused
    for k, v in p["g_net"].decoder.state_dict().items():
        assert torch.equal(v, p["g_dec"][k]), k
    for k, v in p["d_net"].state_dict().items():
        assert torch.equal(v, p["d_sd"][k]), k
    for k in ("encoder.stem.Conv_0.kernel", "encoder.down1.ConvBlock_0.Conv_0.kernel",
              "encoder.down0.ConvBlock_1.gn_scale"):
        assert not torch.equal(p["g_net"].state_dict()[k], p["g_init"][k]), k


def test_fused_trajectory_follows_unfused(parity, parity_fused):
    """Flags on against flags off in the port: the same function, so the
    same losses to the parity bound at every step of both stages."""
    for stage in ("s1", "s2"):
        _compare(parity[stage][1], parity_fused[stage][1])


@pytest.fixture(scope="module")
def parity_fusion():
    """The same run with use_pallas_fusion: the UpBlock up-convs through
    the upsample entry point and the FusionBlocks through the per-image
    fusion one (on the CPU their plain versions, inside the Function
    whose backward is the VJP of the fp32 reference); in the JAX package,
    on the CPU, the XLA route of the same function."""
    return _run_parity(dict(SMALL, **FUSION))


def test_stage1_training_parity_fusion(parity_fusion):
    _compare(*parity_fusion["s1"])
    assert parity_fusion["s1"][1][-1]["total"] < parity_fusion["s1"][1][0]["total"]


def test_stage2_training_parity_fusion(parity_fusion):
    _compare(*parity_fusion["s2"])
    assert "latent" in parity_fusion["s2"][1][0]


@pytest.fixture(scope="module")
def parity_none():
    """The same run on the variant without normalization (``norm="none"``:
    a biased conv and the activation at every site), the net whose
    convergence protocol spread furthest between devices and seeds."""
    return _run_parity(dict(SMALL, norm="none"))


def test_stage1_training_parity_norm_none(parity_none):
    _compare(*parity_none["s1"])
    assert parity_none["s1"][1][-1]["total"] < parity_none["s1"][1][0]["total"]


def test_stage2_training_parity_norm_none(parity_none):
    _compare(*parity_none["s2"])
    assert "latent" in parity_none["s2"][1][0]


def test_stage2_freezes_decoder_and_dnet_fusion(parity_fusion):
    p = parity_fusion
    for k, v in p["g_net"].decoder.state_dict().items():
        assert torch.equal(v, p["g_dec"][k]), k
    for k, v in p["d_net"].state_dict().items():
        assert torch.equal(v, p["d_sd"][k]), k
    for k in ("encoder.stem.Conv_0.kernel", "encoder.down1.ConvBlock_0.Conv_0.kernel"):
        assert not torch.equal(p["g_net"].state_dict()[k], p["g_init"][k]), k


def test_fusion_trajectory_follows_unfused(parity, parity_fusion):
    """use_pallas_fusion on against off in the port: the same function,
    so the same losses to the parity bound at every step of both stages."""
    for stage in ("s1", "s2"):
        _compare(parity[stage][1], parity_fusion[stage][1])


def test_transfer_refuses_mismatched_decoder():
    _, tc = _cfgs()
    g = RtoDNet(tc.model).state_dict()
    other = tcfg.ModelConfig(**dict(SMALL, dec_channels=(16, 16)))
    with pytest.raises(ValueError, match="shape-compatible"):
        transfer_stage1_decoder(g, DtoDNet(other).state_dict())


# ------------------------------------------------ loops, data, logger, CLI

def _tiny_cfg(tmp_path):
    return tcfg.Config(
        model=tcfg.ModelConfig(**SMALL),
        data=tcfg.DataConfig(dataset="synthetic", batch_size=2),
        train=tcfg.TrainConfig(lr=1e-3, steps_per_epoch=3, log_every=1,
                               ckpt_dir=str(tmp_path)),
    )


def test_train_loops_log_and_write_pth(tmp_path):
    cfg = _tiny_cfg(tmp_path)
    data = SyntheticDataset(2, *HW, 80.0, seed=1, device="cpu")
    logs = {}
    for stage in ("stage1", "stage2"):
        logs[stage] = str(tmp_path / f"{stage}.jsonl")
    s1 = train_stage1(cfg, data, epochs=2, device="cpu",
                      logger=MetricLogger("stage1", logs["stage1"], io.StringIO()))
    s2 = train_stage2(cfg, data, load_params(str(tmp_path / "stage1")), epochs=2,
                      device="cpu",
                      logger=MetricLogger("stage2", logs["stage2"], io.StringIO()))
    assert s1.step == s2.step == 6
    for stage, keys in (("stage1", {"recon", "grad", "ssim", "total"}),
                        ("stage2", {"recon", "grad", "ssim", "latent", "total"})):
        recs = [json.loads(line) for line in open(logs[stage])]
        assert [r["step"] for r in recs] == [1, 2, 3, 4, 5, 6]
        for r in recs:
            assert keys <= set(r) and all(np.isfinite(r[k]) for k in keys)
        # the first step of each epoch restarts the clock: no rate yet
        assert [("imgs_per_sec" in r) for r in recs] == [False, True, True] * 2
    # a checkpoint an epoch, the newest keep_ckpts (3) of them kept
    assert sorted(os.listdir(tmp_path / "stage1")) == ["3.pt", "6.pt", "config.json"]
    assert latest_step(str(tmp_path / "stage2")) == 6
    d_sd = load_params(str(tmp_path / "stage1"))
    DtoDNet(cfg.model).load_state_dict(d_sd, strict=True)
    g_sd = load_params(str(tmp_path / "stage2"))
    for k, v in s2.net.state_dict().items():
        assert torch.equal(g_sd[k], v), k
    for k in g_sd:  # the frozen decoder is stage 1's
        if k.startswith("decoder."):
            assert torch.equal(g_sd[k], d_sd[k]), k
    depth = BatchedPredictor(cfg, g_sd, batch_size=2, device="cpu").predict(
        np.random.default_rng(0).integers(0, 256, (3, *HW, 3), np.uint8))
    assert depth.shape == (3, *HW) and np.isfinite(depth).all()


def test_entry_points_refuse_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs a machine without one")
    cfg = _tiny_cfg(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        SyntheticDataset(2, *HW, 80.0)
    data = SyntheticDataset(2, *HW, 80.0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_stage1(cfg, data)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_stage2(cfg, data, DtoDNet(cfg.model).state_dict())


def test_synthetic_dataset_is_seekable_and_shaped():
    ds = SyntheticDataset(3, 16, 40, 80.0, seed=5, device="cpu")
    it = iter(ds)
    first = [next(it) for _ in range(3)]
    ds.seek(2)
    again = next(iter(ds))
    for k in first[2]:
        assert torch.equal(first[2][k], again[k])
    b = first[0]
    assert b["rgb"].shape == (3, 16, 40, 3) and b["depth"].shape == (3, 16, 40, 1)
    assert b["mask"].shape == (3, 16, 40, 1)
    assert 0.5 <= float(b["depth"].min()) and float(b["depth"].max()) <= 80.0
    assert 0.0 <= float(b["rgb"].min()) and float(b["rgb"].max()) <= 1.0
    assert 0.85 < float(b["mask"].mean()) < 1.0
    assert not torch.equal(first[0]["depth"], first[1]["depth"])


def test_metric_logger_matches_jax_format(tmp_path):
    outs = []
    for cls, name in ((MetricLogger, "t"), (JLogger, "j")):
        buf = io.StringIO()
        lg = cls("stage2", str(tmp_path / f"{name}.jsonl"), buf)
        lg.log(step=3, recon=1.5, total=2.25, imgs_per_sec=10.0)
        lg.close()
        rec = json.loads(open(tmp_path / f"{name}.jsonl").read())
        rec.pop("t")
        outs.append((buf.getvalue(), rec))
    assert outs[0] == outs[1]


def _script(*args):
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "train_torch.py"), *args],
        cwd=REPO, capture_output=True, text=True, timeout=300)


def test_train_script_both_stages_on_cpu(tmp_path):
    common = ["--dataset", "synthetic", "--device", "cpu", "--dtype", "float32",
              "--height", "16", "--width", "32", "--batch_size", "1", "--epochs", "2",
              "--steps_per_epoch", "1", "--log_every", "1", "--ckpt_dir", str(tmp_path)]
    one = _script("--mode", "DtoD", *common)
    assert one.returncode == 0, one.stderr
    two = _script("--mode", "RtoD", *common)  # reads <ckpt_dir>/stage1
    assert two.returncode == 0, two.stderr
    assert "[stage2] step=2" in two.stdout  # one step in each of 2 epochs
    assert "stage 2 finished at step 2" in two.stdout
    recs = [json.loads(line) for line in open(tmp_path / "train_log.jsonl")]
    assert [r["step"] for r in recs] == [1, 2, 1, 2]
    g_sd = load_params(str(tmp_path / "stage2"))
    cfg = tcfg.kitti_config(**{"model.image_size": (16, 32), "model.use_pallas_gn": True})
    RtoDNet(cfg.model).load_state_dict(g_sd, strict=True)


def test_train_script_fused_flags_reach_the_config(tmp_path):
    common = ["--dataset", "synthetic", "--device", "cpu", "--dtype", "float32",
              "--height", "16", "--width", "32", "--batch_size", "1", "--epochs", "1",
              "--steps_per_epoch", "1", "--log_every", "1", "--ckpt_dir", str(tmp_path)]
    flags = [f"--model.{f}" for f in tcfg.FUSED_KERNEL_FLAGS]
    spec = importlib.util.spec_from_file_location(
        "train_torch_script", os.path.join(REPO, "scripts", "train_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    model = script.build_config(script.parse_args(common + flags)).model
    assert all(getattr(model, f) for f in tcfg.FUSED_KERNEL_FLAGS)
    off = script.build_config(script.parse_args(common)).model
    assert not any(getattr(off, f) for f in tcfg.FUSED_KERNEL_FLAGS)
    # and the script trains a step of each stage with them on
    one = _script("--mode", "DtoD", *common, *flags[1:])
    assert one.returncode == 0, one.stderr
    two = _script("--mode", "RtoD", *common, *flags[1:])
    assert two.returncode == 0, two.stderr
    assert "[stage2] step=1" in two.stdout


def test_train_script_refuses_cpu_fallback_and_real_data(tmp_path):
    if not torch.cuda.is_available():
        out = _script("--dataset", "synthetic", "--ckpt_dir", str(tmp_path))
        assert out.returncode != 0 and "no CUDA device" in out.stderr
    # the grain loader's counterpart reads data on disk, not the synthetic source
    out = _script("--dataset", "synthetic", "--device", "cpu", "--loader", "grain")
    assert out.returncode != 0 and "on-disk dataset" in out.stderr


