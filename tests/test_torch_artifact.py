"""The port's serving artifact (``gdn_tpu_torch/serving.py``:
``export_model``, ``load_model``, ``BatchedPredictor.from_artifact``)
and the registered ops its graph calls (``gdn_tpu_torch/kernels/ops.py``),
on the CPU at a small size.

On the CPU each op runs its kernel's plain version, as the wrappers do,
so an artifact reloaded here computes what the eager predictor computes:
held bit for bit.  Against the JAX package's StableHLO artifact of the
same weights: rtol 1e-4 / atol 1e-3 m (``tests/test_serving.py``'s
bound for two compilations of one net).  Every artifact is exported
once for the module (``artifacts``).
"""

import io
import json
import os
import subprocess
import sys
import urllib.request

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from gdn_tpu import config as jcfg
from gdn_tpu.models import RtoDNet as JRtoD
from gdn_tpu.serving import export_model as jexport, load_model as jload
from gdn_tpu_torch import checkpoint as ckpt
from gdn_tpu_torch import config as tcfg
from gdn_tpu_torch.kernels import ops
from gdn_tpu_torch.ops.quant import quantized_model_and_scales, synthetic_calibration_batches
from gdn_tpu_torch.server import DepthServer
from gdn_tpu_torch.serving import BatchedPredictor, export_model, load_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (32, 64)
SMALL = dict(image_size=HW, enc_channels=(8, 16), dec_channels=(16, 8), dtype="float32",
             use_pallas_gn=True)
CONFIGS = {
    "unfused": {},
    "fused": dict(use_pallas_convgn_bt=True, use_pallas_convgn_s2=True,
                  use_pallas_fusion_bt=True),
    "fusion": dict(use_pallas_fusion=True),
    "v1": dict(use_pallas_convgn=True),
    "all": dict(use_pallas_convgn_bt=True, use_pallas_convgn_s2=True,
                use_pallas_fusion_bt=True, use_pallas_fusion=True),
    "int8": dict(quant="int8"),
}
# op nodes of each graph: GN+ELU sites, then fused calls by entry point
# (two scales: 1 stem + 2 x 2 encoder convs + 2 up-convs + 2 fusions)
NODES = {
    "unfused": (9, {}),
    "fused": (3, {"fused_conv_gn_elu_s2": 2, "fused_conv_gn_elu_bt": 2,
                  "fused_fusion_bt": 2}),
    "fusion": (5, {"fused_upsample_conv": 2, "fused_fusion_block": 2}),
    "v1": (7, {"fused_conv_gn_elu": 2}),
    "all": (1, {"fused_conv_gn_elu_s2": 2, "fused_conv_gn_elu_bt": 2,
                "fused_fusion_bt": 2, "fused_upsample_conv": 2}),
    "int8": (9, {}),
}
BATCH = 2


def _cfg(name):
    return tcfg.Config(model=tcfg.ModelConfig(**SMALL, **CONFIGS[name]))


@pytest.fixture(scope="module")
def flax_params():
    net = JRtoD(cfg=jcfg.ModelConfig(**SMALL))
    init = jax.jit(lambda x: net.init(jax.random.PRNGKey(0), x))
    x = np.zeros((1, *HW, 3), np.float32)
    return jax.tree_util.tree_map(np.asarray, init(x)["params"])


@pytest.fixture(scope="module")
def sd(flax_params):
    return ckpt.params_from_flax(flax_params)


@pytest.fixture(scope="module")
def scales(sd):
    batches = list(synthetic_calibration_batches(_cfg("int8"), 2, 4))
    return quantized_model_and_scales(_cfg("int8"), sd, calib_batches=batches,
                                      device="cpu")[1]


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory, sd, scales):
    """{config name: .pt2 exported at batch 2 on the CPU}."""
    root = tmp_path_factory.mktemp("artifacts")
    out = {}
    for name in CONFIGS:
        out[name] = str(root / f"{name}.pt2")
        export_model(_cfg(name), sd, out[name], batch_size=BATCH, device="cpu",
                     quant_scales=scales if name == "int8" else None)
    return out


def _predictor(name, sd, scales, batch=BATCH):
    return BatchedPredictor(_cfg(name), sd, batch_size=batch, device="cpu",
                            quant_scales=scales if name == "int8" else None)


def _images(seed, n, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, (n, *HW, 3), np.uint8)
    return rng.uniform(0, 1, (n, *HW, 3)).astype(np.float32)


# ------------------------------------------------------------ registered ops

def _cl(*shape, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype).contiguous(memory_format=torch.channels_last)


def _w(cout, cin, seed=1):
    return torch.randn((cout, cin, 3, 3), generator=torch.Generator().manual_seed(seed)) * 0.2


AFFINE = (torch.linspace(0.5, 1.5, 16), torch.linspace(-0.2, 0.2, 16))
OP_CASES = {
    "gn_fp32": (ops.group_norm_elu, (_cl(2, 16, 5, 7), *AFFINE, 4, 1e-6)),
    "gn_bf16": (ops.group_norm_elu, (_cl(2, 16, 5, 7, dtype=torch.bfloat16), *AFFINE, 4,
                                     1e-6)),
    "conv_gn_elu": (ops.conv_gn_elu, ("fused_conv_gn_elu", _cl(2, 8, 6, 9), None,
                                      _w(16, 8), None, *AFFINE, 4, 1e-6, 1, False,
                                      "float32", torch.float32)),
    "conv_gn_elu_bt": (ops.conv_gn_elu, ("fused_conv_gn_elu_bt",
                                         _cl(2, 8, 6, 9, dtype=torch.bfloat16), None,
                                         _w(16, 8), None, *AFFINE, 4, 1e-6, 1, False,
                                         "bfloat16", torch.bfloat16)),
    "conv_gn_elu_s2": (ops.conv_gn_elu, ("fused_conv_gn_elu_s2", _cl(2, 8, 7, 9), None,
                                         _w(16, 8), None, *AFFINE, 4, 1e-6, 2, False,
                                         "bfloat16", torch.float32)),
    "fusion_bt": (ops.conv_gn_elu, ("fused_fusion_bt", _cl(2, 8, 6, 9), _cl(2, 4, 6, 9),
                                    _w(16, 8), _w(16, 4, 2), *AFFINE, 4, 1e-6, 1, False,
                                    "bfloat16", torch.float32)),
    "fusion_block": (ops.conv_gn_elu, ("fused_fusion_block", _cl(2, 8, 6, 9),
                                       _cl(2, 4, 6, 9), _w(16, 8), _w(16, 4, 2), *AFFINE, 4,
                                       1e-6, 1, False, "float32", torch.float32)),
    "upsample": (ops.conv_gn_elu, ("fused_upsample_conv", _cl(2, 8, 3, 5), None, _w(16, 8),
                                   None, *AFFINE, 4, 1e-6, 1, True, "float32",
                                   torch.float32)),
}


@pytest.mark.parametrize("case", list(OP_CASES))
def test_registered_ops_pass_opcheck(case):
    """Schema, fake (shape, dtype, channels_last strides) and the CPU
    implementation of each op, at every entry point's arguments."""
    op, args = OP_CASES[case]
    torch.library.opcheck(op, args)
    out = op(*args)
    assert out.is_contiguous(memory_format=torch.channels_last)


# ------------------------------------------------------------ the artifact

@pytest.mark.parametrize("name", list(CONFIGS))
def test_exported_graph_holds_the_ops(artifacts, name):
    program = torch.export.load(artifacts[name])
    targets = [n for n in program.graph.nodes if n.op == "call_function"]
    gn = sum(n.target == torch.ops.gdn_tpu_torch.group_norm_elu.default for n in targets)
    conv = {}
    for n in targets:
        if n.target == torch.ops.gdn_tpu_torch.conv_gn_elu.default:
            conv[n.args[0]] = conv.get(n.args[0], 0) + 1
    assert (gn, conv) == NODES[name]
    int_mm = sum(n.target == torch.ops.aten._int_mm.default for n in targets)
    assert int_mm == (9 if name == "int8" else 0)


@pytest.mark.parametrize("name", ["unfused", "fused", "fusion", "int8"])
def test_reloaded_artifact_equals_the_eager_predictor(artifacts, sd, scales, name):
    rgb = _images(1, BATCH, np.float32)
    want = _predictor(name, sd, scales).predict(rgb)
    got = load_model(artifacts[name])(torch.from_numpy(rgb)).numpy()
    assert got.shape == (BATCH, *HW, 1)
    np.testing.assert_array_equal(got[..., 0], want)


def test_artifact_matches_the_jax_artifact(artifacts, flax_params, tmp_path):
    path = str(tmp_path / "model.stablehlo")
    jexport(jcfg.Config(model=jcfg.ModelConfig(**SMALL)), flax_params, path,
            batch_size=BATCH)
    rgb = _images(2, BATCH, np.float32)
    want = np.asarray(jload(path)(rgb))
    got = load_model(artifacts["unfused"])(torch.from_numpy(rgb)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


LOADER = """
import sys
import numpy as np
import torch
import gdn_tpu_torch.kernels
from gdn_tpu_torch.serving import BatchedPredictor

rgb = np.load(sys.argv[1])
out = {}
for path in sys.argv[3:]:
    out[path] = BatchedPredictor.from_artifact(path).predict(rgb)
assert "gdn_tpu_torch.models" not in sys.modules, "the loader imported the models"
np.savez(sys.argv[2], *[out[p] for p in sys.argv[3:]])
"""


def test_artifact_loads_in_a_process_without_model_code(artifacts, sd, scales, tmp_path):
    names = ["all", "int8"]
    rgb = _images(3, 3)
    np.save(tmp_path / "rgb.npy", rgb)
    run = subprocess.run(
        [sys.executable, "-c", LOADER, str(tmp_path / "rgb.npy"), str(tmp_path / "out.npz"),
         *[artifacts[n] for n in names]],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO})
    assert run.returncode == 0, run.stderr[-3000:]
    got = np.load(tmp_path / "out.npz")
    for i, name in enumerate(names):
        np.testing.assert_array_equal(got[f"arr_{i}"], _predictor(name, sd, scales).predict(rgb))


def test_from_artifact_shape_padding_and_wires(artifacts, sd):
    pred = BatchedPredictor.from_artifact(artifacts["unfused"])
    assert pred.batch_size == BATCH and pred.image_size == HW and pred.cfg is None
    assert pred.device == torch.device("cpu")
    rgbs = _images(4, 3, np.float32)
    out = pred.predict(rgbs)
    assert out.shape == (3, *HW)
    # the padded last batch does not move the real images' results
    np.testing.assert_array_equal(out[:2], pred.predict(rgbs[:2]))
    np.testing.assert_array_equal(out, _predictor("unfused", sd, None).predict(rgbs))
    u8 = _images(5, 2)
    np.testing.assert_allclose(pred.predict(u8), pred.predict(u8.astype(np.float32) / 255.0),
                               rtol=1e-5, atol=1e-4)
    d32, d16 = pred.predict(u8), pred.predict(u8, wire="u16")
    assert d16.dtype == np.uint16 and d16.shape == (2, *HW)
    expect = np.clip(np.round(d32.astype(np.float64) * 256.0), 0, 65535).astype(np.int64)
    assert np.abs(d16.astype(np.int64) - expect).max() <= 1
    with pytest.raises(ValueError, match="expected"):
        pred.predict(np.zeros((1, 8, 8, 3), np.uint8))


def test_int8_artifact_equals_the_int8_predictor(artifacts, sd, scales):
    rgbs = _images(6, 3)
    got = BatchedPredictor.from_artifact(artifacts["int8"]).predict(rgbs)
    want = _predictor("int8", sd, scales).predict(rgbs)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="calibrated activation scales"):
        export_model(_cfg("int8"), sd, "unused.pt2", device="cpu")


def test_depth_server_serves_an_artifact(artifacts):
    srv = DepthServer(None, predictor=BatchedPredictor.from_artifact(artifacts["fused"]),
                      port=0, max_wait_ms=1.0)
    srv.start()
    try:
        buf = io.BytesIO()
        Image.fromarray(_images(7, 1)[0][:20, :40]).save(buf, format="PNG")
        base = f"http://127.0.0.1:{srv.port}"
        for fmt in ("npy", "color"):  # color: max_depth unknown, per-image range
            req = urllib.request.Request(f"{base}/predict?format={fmt}",
                                         data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                body = r.read()
                assert r.status == 200
            if fmt == "npy":
                depth = np.load(io.BytesIO(body))
                assert depth.shape == (20, 40) and np.isfinite(depth).all()
            else:
                assert Image.open(io.BytesIO(body)).size == (40, 20)
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["image_size"] == list(HW) and health["batch_size"] == BATCH
    finally:
        srv.stop()


def _load_script(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_export_script_end_to_end(tmp_path, sd):
    """scripts/export_artifact_torch.py on a checkpoint directory: the
    architecture from its config.json, the weights of its newest step;
    with --quantize int8 the scales calibrated on synthetic scenes."""
    cfg = tcfg.kitti_config(**{"model.image_size": HW, "model.enc_channels": (8, 16),
                               "model.dec_channels": (16, 8)})
    stage2 = str(tmp_path / "ck" / "stage2")
    ckpt.save_config(stage2, cfg)
    ckpt._write(stage2, 1, {"params": sd, "step": 1}, 0)
    mod = _load_script("export_artifact_torch")
    argv = ["--ckpt_dir", str(tmp_path / "ck"), "--device", "cpu", "--dtype", "float32",
            "--export_batch", "1", "--model.use_pallas_fusion"]
    mod.main(argv + ["--output", str(tmp_path / "m.pt2")])
    mod.main(argv + ["--output", str(tmp_path / "q.pt2"), "--quantize", "int8"])
    rgb = _images(8, 2, np.float32)
    pred = BatchedPredictor.from_artifact(str(tmp_path / "m.pt2"))
    want = _predictor("fusion", sd, None, batch=1).predict(rgb)
    np.testing.assert_array_equal(pred.predict(rgb), want)
    q = torch.export.load(str(tmp_path / "q.pt2"))
    assert sum(n.target == torch.ops.aten._int_mm.default for n in q.graph.nodes) == 9
    assert np.isfinite(BatchedPredictor.from_artifact(str(tmp_path / "q.pt2")).predict(rgb)).all()
