"""The remat policies of the PyTorch port (``TrainConfig.remat_policy``,
``train/steps.py::REMAT_SAVED``), on the CPU at the small test net, fp32.

- Every ported policy (jax.checkpoint_policies' policies by name)
  changes no loss term and no gradient (atol 1e-6, as
  tests/test_torch_resume.py holds the plain remat), in both stages,
  and on the fused and fusion routes.
- The recompute follows the policy: counted on the CPU, where each
  kernel wrapper runs its plain version, as the convolutions that
  execute (a dispatch mode under the checkpoint's own) and the calls of
  the GroupNorm+ELU plain version.  ``nothing_saveable`` and the
  no-batch-dims policies run the trained net's convolutions twice (this
  net has no matmul), ``dots_saveable`` once, ``everything_saveable``
  takes no checkpoint; the GroupNorm+ELU sites run twice under every
  policy but ``everything_saveable``: a policy cannot keep what a kernel
  computes (on the card the kernels launch through ctypes, outside the
  dispatcher).
- The names of jax's policy factories are refused, as are unknown names;
  the two lists are jax's own.
"""

import jax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gdn_tpu_torch import config as tcfg
from gdn_tpu_torch.checkpoint import init_params, transfer_stage1_decoder
from gdn_tpu_torch.data.synthetic import SyntheticDataset
from gdn_tpu_torch.kernels import groupnorm as gnk
from gdn_tpu_torch.models import DtoDNet, RtoDNet
from gdn_tpu_torch.train import steps as tsteps

HW = (16, 32)
SMALL = dict(image_size=HW, enc_channels=(8, 16), dec_channels=(16, 8),
             dtype="float32", use_pallas_gn=True)
ROUTES = {"unfused": {}, "fused": dict(use_pallas_convgn_bt=True, use_pallas_convgn_s2=True,
                                       use_pallas_fusion_bt=True),
          "fusion": dict(use_pallas_fusion=True)}
GN = 9  # GroupNorm+ELU sites of the small net: stem, 2 x 2 down, 2 x 2 up
RECOMPUTE = {  # policy -> (convolutions, GroupNorm+ELU calls) of the trained net a step
    "nothing_saveable": (2, 2),
    "dots_saveable": (1, 2),
    "checkpoint_dots": (1, 2),
    "dots_with_no_batch_dims_saveable": (2, 2),
    "checkpoint_dots_with_no_batch_dims": (2, 2),
    "everything_saveable": (1, 1),
}


def _batch(seed=0):
    return next(iter(SyntheticDataset(2, *HW, 80.0, seed=seed, device="cpu")))


def _loss(cfg, stage, batch):
    """A fresh pair of nets (seed 5) and one step's loss, before backward."""
    gen = torch.Generator().manual_seed(5)
    d_net = DtoDNet(cfg.model)
    d_net.load_state_dict(init_params(cfg.model, gen, in_channels=1))
    if stage == 1:
        return d_net, None, tsteps._stage1_loss(d_net, batch, cfg)
    net = RtoDNet(cfg.model)
    net.load_state_dict(transfer_stage1_decoder(init_params(cfg.model, gen, in_channels=3),
                                                d_net.state_dict()))
    net.decoder.requires_grad_(False)
    d_net.requires_grad_(False)
    return net, d_net, tsteps._stage2_loss(net, d_net, batch, cfg)


def _grads(cfg, stage, batch):
    net, _, terms = _loss(cfg, stage, batch)
    terms["total"].backward()
    return ({k: float(v.detach()) for k, v in terms.items()},
            {k: p.grad for k, p in net.named_parameters() if p.requires_grad})


def _cfg(route="unfused", **train):
    return tcfg.Config(model=tcfg.ModelConfig(**SMALL, **ROUTES[route]),
                       train=tcfg.TrainConfig(**train))


def _same(a, b):
    (t0, g0), (t1, g1) = a, b
    assert t1 == t0
    assert g0.keys() == g1.keys()
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=1e-6, msg=k)


@pytest.mark.parametrize("stage", [1, 2])
@pytest.mark.parametrize("policy", list(tcfg.REMAT_POLICIES))
def test_policy_changes_no_gradient(policy, stage):
    batch = _batch(2)
    _same(_grads(_cfg(), stage, batch),
          _grads(_cfg(remat=True, remat_policy=policy), stage, batch))


@pytest.mark.parametrize("route", ["fused", "fusion"])
@pytest.mark.parametrize("policy", ["dots_saveable", "dots_with_no_batch_dims_saveable"])
def test_policy_changes_no_gradient_on_the_fused_routes(policy, route):
    batch = _batch(3)
    _same(_grads(_cfg(route), 2, batch),
          _grads(_cfg(route, remat=True, remat_policy=policy), 2, batch))


class _Convs(TorchDispatchMode):
    """Counts the convolutions that execute (pushed below the
    checkpoint's modes, it sees no convolution a policy replays)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture
def gn_calls(monkeypatch):
    """A counter of the GroupNorm+ELU plain version's calls."""
    gn = [0]
    plain = gnk.group_norm_elu_analytic

    def counted(*a, **k):
        gn[0] += 1
        return plain(*a, **k)

    monkeypatch.setattr(gnk, "group_norm_elu_analytic", counted)
    return gn


@pytest.mark.parametrize("policy", list(RECOMPUTE))
def test_recompute_follows_the_policy(policy, gn_calls):
    """Stage 1 (the trained D-net) and stage 2 (the trained G-net beside
    the frozen D-net, which runs once, outside the checkpoint): the
    trained net's convolutions and GroupNorm+ELU calls a step, forward
    and recompute, as RECOMPUTE says."""
    cfg = _cfg()
    with _Convs() as mode:
        DtoDNet(cfg.model)(_batch(1)["depth"])
    convs_a_net = mode.n  # the composed up-conv is several convolutions
    assert gn_calls[0] == GN  # under grad; without, the registered op runs
    convs, gns = RECOMPUTE[policy]
    for stage, frozen in ((1, 0), (2, 1)):
        cfg = _cfg(remat=True, remat_policy=policy)
        gn_calls[0] = 0
        with _Convs() as mode:
            _, _, terms = _loss(cfg, stage, _batch(1))
            forward = (mode.n, gn_calls[0])
            terms["total"].backward()
        assert forward == (convs_a_net * (1 + frozen), GN), (policy, stage)
        assert (mode.n, gn_calls[0]) == (convs_a_net * (convs + frozen), GN * gns), (
            policy, stage)


@pytest.mark.parametrize("name", list(tcfg.REMAT_FACTORIES))
def test_policy_factories_are_refused(name):
    with pytest.raises(ValueError, match="factory of jax.checkpoint_policies, not a policy"):
        tcfg.TrainConfig(remat_policy=name)


def test_unknown_policy_names_are_refused():
    with pytest.raises(ValueError, match="unknown remat_policy 'dots'"):
        tcfg.TrainConfig(remat=True, remat_policy="dots")


def test_the_names_are_jax_checkpoint_policies():
    """REMAT_POLICIES are jax's policies (called on a primitive, they
    answer), REMAT_FACTORIES its factories; together every public name
    of jax.checkpoint_policies; and train.steps maps each policy."""
    public = {n for n in dir(jax.checkpoint_policies) if not n.startswith("_")}
    assert set(tcfg.REMAT_POLICIES) | set(tcfg.REMAT_FACTORIES) == public
    assert not set(tcfg.REMAT_POLICIES) & set(tcfg.REMAT_FACTORIES)
    assert set(tsteps.REMAT_SAVED) == set(tcfg.REMAT_POLICIES)
    conv = jax.lax.conv_general_dilated_p
    for name in tcfg.REMAT_POLICIES:
        saves = getattr(jax.checkpoint_policies, name)(conv)
        assert isinstance(saves, bool), name
        kept = tsteps.REMAT_SAVED[name]
        assert saves == (kept is None or torch.ops.aten.convolution.default in kept), name
