"""The rank side of the port's parallel tests: functions that run in the
ranks ``gdn_tpu_torch.parallel.multihost.run_ranks`` spawns (gloo on the
CPU), imported by the children by name.  They import torch and the port
only; the JAX references run in the pytest process.

Each function reads its inputs from ``inp`` (a ``torch.save`` file the
test wrote) and writes what the test compares to ``out`` (a directory):
rank 0 writes ``<scenario>.npz`` (the global, gathered values), every
rank writes what is its own (``<scenario>.rank<r>.npz``).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from gdn_tpu_torch import config as tcfg
from gdn_tpu_torch.models import DtoDNet, RtoDNet
from gdn_tpu_torch.parallel import multihost
from gdn_tpu_torch.parallel.mesh import (
    create_mesh, data_size, full_tensor, is_sharded, local, param_mode, shard_batch,
    shard_frozen, shard_stacked_batch, shard_state,
)
from gdn_tpu_torch.train import steps as tsteps
from gdn_tpu_torch.train.state import TrainState

SMALL = dict(image_size=(16, 32), enc_channels=(8, 16), dec_channels=(16, 8),
             dtype="float32", use_pallas_gn=True)


B, HW = 4, SMALL["image_size"]


def batches(n: int = 2, seed: int = 0):
    """Global batches of 4 (numpy): rows 0-1 (rank 0) ~30% valid, rows
    2-3 (rank 1) ~70%, continuous depth and RGB."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        depth = rng.uniform(1.0, 79.0, (B, *HW, 1)).astype(np.float32)
        p = np.array([0.3, 0.3, 0.7, 0.7], np.float32)[:, None, None, None]
        mask = (rng.random((B, *HW, 1)) < p).astype(np.float32)
        rgb = rng.random((B, *HW, 3)).astype(np.float32)
        out.append({"depth": depth, "mask": mask, "rgb": rgb})
    return out


def weights():
    """The D-net and the G-net with its transferred decoder, drawn by the
    port's init (seed 3)."""
    from gdn_tpu_torch.checkpoint import init_params, transfer_stage1_decoder

    cfg = config()
    gen = torch.Generator().manual_seed(3)
    d = init_params(cfg.model, gen, in_channels=1)
    g = transfer_stage1_decoder(init_params(cfg.model, gen, in_channels=3), d)
    return {"d": d, "g": g}


def config(route: str = "unfused", fsdp: bool = False, **train) -> tcfg.Config:
    return tcfg.Config(model=tcfg.ModelConfig(**SMALL),
                       loss=tcfg.LossConfig(use_pallas=route == "fused"),
                       train=tcfg.TrainConfig(lr=1e-3, **train),
                       mesh=tcfg.MeshConfig(fsdp=fsdp))


def nets(sd: Dict[str, Dict[str, torch.Tensor]], stage: int, cfg: tcfg.Config):
    """(trained net, frozen D-net or None) from the test's weights."""
    d = DtoDNet(cfg.model)
    d.load_state_dict(sd["d"])
    if stage == 1:
        return d, None
    g = RtoDNet(cfg.model)
    g.load_state_dict(sd["g"])
    return g, d.requires_grad_(False)


def _save(path: str, **arrays) -> None:
    np.savez(path, **{k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
                      for k, v in arrays.items()})


class GradTap:
    """The gradients the optimizer is handed at each update, whole
    (after the ranks' sum and the clip), by parameter name."""

    def __init__(self, state: TrainState):
        self.names = [k for k, p in state.net.named_parameters() if p.requires_grad]
        self.grads = []
        state.optimizer.register_step_pre_hook(self._hook)
        self.state = state

    def _hook(self, opt, args, kwargs):
        grads = {k: p.grad for k, p in zip(self.names, self.state.params)}
        if self.state.mode == "tp":  # tensor-parallel slices, gathered whole
            grads = self.state._whole(grads)
        self.grads.append({k: full_tensor(g).detach().clone() for k, g in grads.items()})


def run(cfg, stage, sd, batches, mesh, stacked=False, extra=None):
    """Steps of one stage on ``batches`` (global batches), data parallel
    over ``mesh`` (None: one process, the reference); returns (state,
    terms per step, GradTap)."""
    net, d_net = nets(sd, stage, cfg)
    if extra is not None:  # a trainable parameter no loss term reaches
        net.register_parameter("unused", torch.nn.Parameter(extra.clone()))
    state = TrainState(net, cfg.train, 10, freeze_decoder=stage == 2)
    state, specs = shard_state(state, mesh, param_mode(cfg.mesh))
    if d_net is not None:
        d_net = shard_frozen(d_net, mesh, param_mode(cfg.mesh))
    tap = GradTap(state)
    k = cfg.train.steps_per_call
    if stage == 1:
        step = (tsteps.make_stage1_multistep(cfg, k, mesh, specs) if k > 1
                else tsteps.make_stage1_step(cfg, mesh, specs))
    else:
        step = (tsteps.make_stage2_multistep(cfg, k, mesh, specs) if k > 1
                else tsteps.make_stage2_step(cfg, mesh, specs))
    extra_args = () if d_net is None else (d_net,)
    terms = []
    if stacked:
        batches = [{key: torch.stack([b[key] for b in batches]) for key in batches[0]}]
    for b in batches:
        b = shard_stacked_batch(b, mesh) if stacked else shard_batch(b, mesh)
        state, t = step(state, *extra_args, b)
        terms.append({key: float(v) for key, v in t.items()})
    return state, terms, tap


def terms_arrays(terms):
    return {f"term/{i}/{k}": v for i, t in enumerate(terms) for k, v in t.items()}


def state_arrays(state: TrainState, tap: GradTap):
    out = {}
    sd = state.state_dict()
    for k, v in sd["params"].items():
        out[f"param/{k}"] = v
    for k, v in (sd.get("ema") or {}).items():
        out[f"ema/{k}"] = v
    for i, g in enumerate(tap.grads):
        for k, v in g.items():
            out[f"grad/{i}/{k}"] = v
    return out


def _bytes(state: TrainState):
    """This rank's bytes of each trained parameter and of its Adam
    moments, beside the parameter's whole size."""
    out = {}
    names = [k for k, p in state.net.named_parameters() if p.requires_grad]
    for k, p in zip(names, state.params):
        moments = state.optimizer.state.get(p, {})
        out[f"pbytes/{k}"] = local(p).nbytes
        out[f"full/{k}"] = p.numel() * p.element_size()
        out[f"obytes/{k}"] = sum(local(v).nbytes for n, v in moments.items() if n != "step")
        out[f"sharded/{k}"] = int(is_sharded(p))
    return out


def train_scenarios(inp: str, out: str) -> None:
    """Every training scenario of tests/test_torch_parallel_train.py."""
    data = torch.load(inp, weights_only=False)
    sd, b = data["sd"], data["batches"]
    mesh = create_mesh(0, device_type="cpu")
    r = multihost.rank()

    def emit(name, state, terms, tap, **more):
        arrays = {**terms_arrays(terms), **state_arrays(state, tap), **more}
        if r == 0:
            _save(os.path.join(out, f"{name}.npz"), **arrays)

    for stage in (1, 2):
        for route in ("unfused", "fused"):
            state, terms, tap = run(config(route), stage, sd, b[:1], mesh)
            emit(f"dp_s{stage}_{route}", state, terms, tap)
    for stage in (1, 2):
        cfg = config(fsdp=True, ema_decay=0.9, grad_clip=0.05 if stage == 1 else None)
        state, terms, tap = run(cfg, stage, sd, b[:2], mesh)
        emit(f"fsdp_s{stage}", state, terms, tap)
        _save(os.path.join(out, f"fsdp_s{stage}.rank{r}.npz"), **_bytes(state))
    state, terms, tap = run(config(grad_accum=2, ema_decay=0.9), 2, sd, b[:2], mesh)
    emit("accum_ema", state, terms, tap)
    state, terms, tap = run(config(fsdp=True, grad_accum=2, ema_decay=0.9), 2, sd, b[:2],
                            mesh)
    emit("accum_ema_fsdp", state, terms, tap)
    state, terms, tap = run(config(steps_per_call=2), 1, sd, b[:2], mesh, stacked=True)
    emit("multistep", state, terms, tap)
    state, terms, tap = run(config(remat=True), 1, sd, b[:1], mesh)
    emit("remat", state, terms, tap)
    for mode in (False, True):
        cfg = config(fsdp=mode)
        state, terms, tap = run(cfg, 1, sd, b[:1], mesh, extra=torch.ones(3, 5))
        emit(f"unused_{'fsdp' if mode else 'dp'}", state, terms, tap,
             unused=full_tensor(state.net.unused.detach()))
    assert data_size(mesh) == 2


class StubMesh:
    """A 1-D data mesh as rank ``rank`` of ``size`` sees it, without a
    process group: enough for the row rules (``local_rows``), not for a
    collective."""

    mesh_dim_names = ("data",)

    def __init__(self, size: int, rank: int = 0):
        self._size, self._rank = size, rank

    def size(self, dim: int = 0) -> int:
        return self._size

    def get_local_rank(self, name=None) -> int:
        return self._rank

    def get_group(self, name=None):
        return None


# ------------------------------------------------------ loop-level scenarios

def analytic_forward(rgb: torch.Tensor) -> torch.Tensor:
    """A depth map from RGB without a net: the protocol is under test
    (tests/test_torch_evaluate.py's forward)."""
    return 2.0 + 60.0 * torch.sigmoid(3.0 * rgb.float().mean(dim=-1, keepdim=True) - 1.0)


def loop_config(tmp: str, name: str, fsdp: bool = False, **train) -> tcfg.Config:
    """The small net at global batch 4 for the loops, checkpoints under
    ``tmp/name`` (synchronous: the test reads them at once)."""
    train = {"lr": 1e-3, "steps_per_epoch": 2, "log_every": 1, "async_ckpt": False, **train}
    return tcfg.Config(model=tcfg.ModelConfig(**SMALL),
                       data=tcfg.DataConfig(dataset="synthetic", batch_size=4),
                       train=tcfg.TrainConfig(ckpt_dir=os.path.join(tmp, name), **train),
                       eval=tcfg.EvalConfig(batch_size=2),
                       mesh=tcfg.MeshConfig(fsdp=fsdp))


def checkpoint_round_trip(sd, batches, out, mesh) -> None:
    """Stage 1 with an EMA: 2 steps on 2 ranks under FSDP (checkpoint
    A), 2 on one device from A (rank 0 alone, checkpoint B), 2 on 2 ranks
    data parallel from B (checkpoint C)."""
    from gdn_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint
    from gdn_tpu_torch.train.loop import train_stage1

    def fresh(cfg):
        return TrainState(nets(sd, 1, cfg)[0], cfg.train, 2)

    cfg = loop_config(out, "ck_a", fsdp=True, ema_decay=0.9)
    train_stage1(cfg, iter(batches[0:2]), epochs=1, state=fresh(cfg), device="cpu")
    if multihost.rank() == 0:
        cfg = loop_config(out, "ck_b", ema_decay=0.9)
        state = restore_checkpoint(os.path.join(out, "ck_a", "stage1"), fresh(cfg))
        step = tsteps.make_stage1_step(cfg)
        for b in batches[2:4]:
            state, _ = step(state, b)
        save_checkpoint(os.path.join(out, "ck_b", "stage1"), state.step, state)
    torch.distributed.barrier()
    cfg = loop_config(out, "ck_c", ema_decay=0.9)
    state = restore_checkpoint(os.path.join(out, "ck_b", "stage1"), fresh(cfg))
    train_stage1(cfg, iter(batches[4:6]), epochs=1, state=state, device="cpu")


def preempt_one_rank(sd, batches, out, mesh) -> None:
    """SIGTERM on rank 1 alone while its third batch is drawn: every rank
    must stop after that step."""
    import signal

    from gdn_tpu_torch.train.loop import train_stage1

    cfg = loop_config(out, "ck_p", steps_per_epoch=6)
    r = multihost.rank()

    def data():
        for i, b in enumerate(batches):
            if i == 2 and r == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            yield b

    state = train_stage1(cfg, data(), epochs=1, device="cpu")
    _save(os.path.join(out, f"preempt.rank{r}.npz"), step=state.step)


def eval_scenarios(sd, samples, out, mesh) -> None:
    """Data-parallel eval: the analytic forward on the pad and mixed
    splits, host-fed and device-cached, and the G-net with predictions
    saved (rank 0 writes them)."""
    from gdn_tpu_torch.evaluate import Evaluator, evaluate
    from gdn_tpu_torch.train.steps import make_eval_forward

    r = multihost.rank()
    cfg = loop_config(out, "unused")
    res = {}
    for split, items in samples.items():
        ev = Evaluator(cfg, analytic_forward, mesh=mesh, device="cpu")
        res.update({f"{split}/host/{k}": v for k, v in ev.run(items, verbose=False).items()})
        assert ev.cache_or_host_fed(items)
        res.update({f"{split}/cached/{k}": v
                    for k, v in ev.run(None, verbose=False).items()})
    g = nets(sd, 2, cfg)[0]
    out_g = evaluate(cfg, make_eval_forward(cfg, g), samples["mixed"], verbose=False,
                     mesh=mesh, device="cpu", save_preds=os.path.join(out, "preds_dp"))
    res.update({f"gnet/{k}": v for k, v in out_g.items()})
    _save(os.path.join(out, f"eval.rank{r}.npz"), **{k: v for k, v in res.items()
                                                     if not k.endswith("fps")})


def stage2_with_eval(sd, batches, samples, out, mesh) -> None:
    """train_stage2 under data parallel with validation and in-training
    eval (rank 0 logs to stage2.jsonl)."""
    from gdn_tpu_torch.train.loop import train_stage2
    from gdn_tpu_torch.utils.logging import MetricLogger

    cfg = loop_config(out, "ck_s2")
    logger = MetricLogger(prefix="stage2", jsonl_path=os.path.join(out, "stage2.jsonl"))
    train_stage2(cfg, iter(batches[:2]), sd["d"], epochs=1, logger=logger,
                 val_iter=batches[2:3], val_steps=1, eval_dataset=lambda: samples["pad"],
                 eval_every=1, device="cpu")
    logger.close()


def pipeline_rows(root, out, mesh) -> None:
    """The augmented pipeline's batches (host-fed and through the device
    cache) and the sharded device cache's, this rank's rows."""
    from gdn_tpu_torch.data.device_cache import DeviceResidentDataset, ShardedDeviceDataset
    from gdn_tpu_torch.data.kitti import KittiTrainDataset
    from gdn_tpu_torch.data.pipeline import make_train_pipeline

    r = multihost.rank()
    cfg = pipeline_config()
    arrays = {}

    def loader(seed=0, **kw):
        return KittiTrainDataset(root, "train.txt", cfg.model.image_size, 4, seed=seed,
                                 max_depth=cfg.model.max_depth, **kw)

    for name, src in (("host", loader()),
                      ("cached", DeviceResidentDataset(loader(), device="cpu", mesh=mesh))):
        pipe = make_train_pipeline(cfg, src, device="cpu", mesh=mesh)
        for i in range(2):
            for k, v in next(pipe).items():
                arrays[f"{name}/{i}/{k}"] = v
        pipe.close()  # stops its prefetch thread
    for tag, skip in (("sharded", 0), ("sharded_seek", 1)):
        ds = ShardedDeviceDataset(loader(loop=False, shuffle=True, seed=7), mesh,
                                  device="cpu")
        ds.seek(skip)
        for i, b in enumerate(ds):
            arrays[f"{tag}/{i}/rgb"] = b["rgb"]
            arrays[f"{tag}/{i}/depth"] = b["depth"]
    _save(os.path.join(out, f"pipeline.rank{r}.npz"), **arrays)


def pipeline_config() -> tcfg.Config:
    return tcfg.Config(model=tcfg.ModelConfig(**dict(SMALL, image_size=(32, 48))),
                       data=tcfg.DataConfig(dataset="kitti", batch_size=4))


def loop_scenarios(inp: str, out: str) -> None:
    """Every scenario of tests/test_torch_parallel_loop.py."""
    data = torch.load(inp, weights_only=False)
    mesh = create_mesh(0, device_type="cpu")
    checkpoint_round_trip(data["sd"], data["batches"], out, mesh)
    preempt_one_rank(data["sd"], data["batches"], out, mesh)
    eval_scenarios(data["sd"], data["samples"], out, mesh)
    stage2_with_eval(data["sd"], data["batches"], data["samples"], out, mesh)
    pipeline_rows(data["root"], out, mesh)
