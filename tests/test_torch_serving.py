"""Serving path of the PyTorch port on the CPU (device="cpu").

Mirrors tests/test_serving.py and tests/test_server.py: partial-batch
padding, the uint8 decode, the u16 wire, DynamicBatcher coalescing and
a DepthServer HTTP round trip.  The slice as a whole is held to the JAX
package's BatchedPredictor on the same carried-over weights.  Also
checks that the port and chip_smoke.py import nothing of JAX or of the
JAX package, and that no entry point quietly runs on the CPU.
"""

import ast
import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from gdn_tpu_torch.checkpoint import init_params
from gdn_tpu_torch.config import Config, ModelConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = Config(model=ModelConfig(
    image_size=(32, 64), enc_channels=(8, 16), dec_channels=(16, 8),
    dtype="float32", use_pallas_gn=True,
))
# the JAX stack, the JAX package, and ml_dtypes (absent on the card's machine)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "gdn_tpu", "ml_dtypes", "grain")


@pytest.fixture(scope="module")
def state_dict():
    return init_params(TINY.model, torch.Generator().manual_seed(1))


def _png_bytes(h, w, seed=0):
    rgb = np.random.default_rng(seed).integers(0, 255, (h, w, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="PNG")
    return buf.getvalue()


def _post(url, body, timeout=60):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _get_json(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


# ------------------------------------------------------------- predictor

def test_predictor_needs_a_card_unless_cpu_is_asked(state_dict, monkeypatch):
    from gdn_tpu_torch.serving import BatchedPredictor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedPredictor(TINY, state_dict)
    assert BatchedPredictor(TINY, state_dict, device="cpu").device.type == "cpu"


def test_batched_predictor_partial_batch(state_dict):
    from gdn_tpu_torch.serving import BatchedPredictor

    pred = BatchedPredictor(TINY, state_dict, batch_size=4, device="cpu")
    rgbs = np.random.default_rng(1).uniform(0, 1, (6, 32, 64, 3)).astype(np.float32)
    out = pred.predict(rgbs)
    assert out.shape == (6, 32, 64) and out.dtype == np.float32
    # padding must not affect the results of real samples
    np.testing.assert_allclose(out[:4], pred.predict(rgbs[:4]), atol=1e-6)
    assert np.isfinite(out).all() and (out > 0).all() and (out <= 80).all()
    with pytest.raises(ValueError, match="expected"):
        pred.predict(rgbs[:, :16])


def test_predictor_uint8_input_matches_host_conversion(state_dict):
    from gdn_tpu_torch.serving import BatchedPredictor

    pred = BatchedPredictor(TINY, state_dict, batch_size=4, device="cpu")
    u8 = np.random.default_rng(2).integers(0, 256, (4, 32, 64, 3)).astype(np.uint8)
    f32 = u8.astype(np.float32) / 255.0
    np.testing.assert_allclose(pred.predict(u8), pred.predict(f32),
                               rtol=1e-5, atol=1e-4)


def test_predictor_u16_wire_matches_png16_encoding(state_dict):
    from gdn_tpu_torch.serving import BatchedPredictor

    pred = BatchedPredictor(TINY, state_dict, batch_size=4, device="cpu")
    rgbs = np.random.default_rng(3).uniform(0, 1, (4, 32, 64, 3)).astype(np.float32)
    d32 = pred.predict(rgbs)
    d16 = pred.predict(rgbs, wire="u16")
    assert d16.dtype == np.uint16
    expect = np.clip(np.round(d32.astype(np.float64) * 256.0), 0, 65535)
    assert np.abs(d16.astype(np.int64) - expect.astype(np.int64)).max() <= 1
    with pytest.raises(ValueError, match="wire"):
        pred.predict(rgbs, wire="f16")


def test_slice_matches_jax_batched_predictor():
    """The port's serving path and the JAX package's, same weights, same
    uint8 images, fp32: rtol 1e-4 / atol 1e-3 m (test_serving.py's
    bound for two compilations of the same net)."""
    from gdn_tpu import config as jcfg
    from gdn_tpu.models import RtoDNet
    from gdn_tpu.serving import BatchedPredictor as JaxPredictor
    from gdn_tpu_torch.checkpoint import params_from_flax
    from gdn_tpu_torch.serving import BatchedPredictor

    jc = jcfg.Config(model=jcfg.ModelConfig(
        image_size=(32, 64), enc_channels=(8, 16), dec_channels=(16, 8),
        dtype="float32", use_pallas_gn=True,
    ))
    params = jax.jit(RtoDNet(cfg=jc.model).init)(
        jax.random.PRNGKey(3), np.zeros((1, 32, 64, 3), np.float32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    u8 = np.random.default_rng(4).integers(0, 256, (3, 32, 64, 3)).astype(np.uint8)
    want = JaxPredictor(jc, params, batch_size=2).predict(u8)
    got = BatchedPredictor(TINY, params_from_flax(params), batch_size=2,
                           device="cpu").predict(u8)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


# --------------------------------------------------------------- batcher

def test_batcher_stop_fails_fast(state_dict):
    from gdn_tpu_torch.server import DynamicBatcher

    b = DynamicBatcher(TINY, state_dict, batch_size=2, max_wait_ms=1.0,
                       device="cpu")
    x = np.zeros((32, 64, 3), np.float32)
    assert b.predict(x).shape == (32, 64)
    b.stop()
    t0 = time.time()
    with pytest.raises(RuntimeError):
        b.predict(x)
    assert time.time() - t0 < 1.0
    assert b.stats["requests"] == 1 and b.stats["errors"] == 0


def test_batcher_coalesces_direct_calls(state_dict):
    from gdn_tpu_torch.server import DynamicBatcher

    b = DynamicBatcher(TINY, state_dict, batch_size=4, max_wait_ms=200.0,
                       device="cpu")
    try:
        rng = np.random.default_rng(5)
        xs = [rng.integers(0, 255, (32, 64, 3), dtype=np.uint8) for _ in range(4)]
        out = [None] * 4

        def call(i):
            out[i] = b.predict(xs[i])

        threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert b.stats["batches"] < 4 and b.stats["batched_items"] == 4
        direct = b._predictor.predict(np.stack(xs))
        for i in range(4):
            np.testing.assert_allclose(out[i], direct[i], rtol=1e-5, atol=1e-5)
    finally:
        b.stop()


# ---------------------------------------------------------------- server

@pytest.fixture(scope="module")
def server(state_dict):
    from gdn_tpu_torch.server import DepthServer

    srv = DepthServer(TINY, state_dict, port=0, batch_size=4,
                      max_wait_ms=50.0, device="cpu")
    srv.start()
    yield srv
    srv.stop()


def test_healthz_and_formats(server):
    base = f"http://127.0.0.1:{server.port}"
    health = _get_json(f"{base}/healthz")
    assert health["status"] == "ok" and health["image_size"] == [32, 64]

    body = _png_bytes(32, 64)
    st, ct, raw = _post(f"{base}/predict", body)
    assert st == 200 and ct == "application/octet-stream"
    depth = np.load(io.BytesIO(raw))
    assert depth.shape == (32, 64) and depth.dtype == np.float32
    assert np.isfinite(depth).all()
    assert (depth >= 0).all() and (depth <= TINY.model.max_depth).all()

    st, ct, raw = _post(f"{base}/predict?format=png16", body)
    assert st == 200 and ct == "image/png"
    d16 = np.asarray(Image.open(io.BytesIO(raw)))
    np.testing.assert_allclose(d16.astype(np.float32) / 256.0, depth,
                               atol=1 / 128.0)

    st, ct, raw = _post(f"{base}/predict?format=color", body)
    assert st == 200
    img = Image.open(io.BytesIO(raw))
    assert img.mode == "RGB" and img.size == (64, 32)


def test_resizes_arbitrary_input_and_rejects_bad_requests(server):
    base = f"http://127.0.0.1:{server.port}"
    st, _, raw = _post(f"{base}/predict", _png_bytes(50, 70, seed=3))
    assert st == 200 and np.load(io.BytesIO(raw)).shape == (50, 70)
    for url, body, code in [
        (f"{base}/predict", b"not an image", 400),
        (f"{base}/predict?format=bogus", _png_bytes(32, 64), 400),
    ]:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, body)
        assert e.value.code == code
    with pytest.raises(urllib.error.HTTPError) as e:
        _get_json(f"{base}/nope")
    assert e.value.code == 404


def test_concurrent_requests_coalesce(server):
    base = f"http://127.0.0.1:{server.port}"
    before = _get_json(f"{base}/stats")
    results = [None] * 8

    def worker(i):
        st, _, raw = _post(f"{base}/predict", _png_bytes(32, 64, seed=i))
        results[i] = (st, np.load(io.BytesIO(raw)))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert all(r is not None and r[0] == 200 for r in results)
    after = _get_json(f"{base}/stats")
    assert after["requests"] - before["requests"] == 8
    assert after["batches"] - before["batches"] < 8
    assert after["mean_batch_occupancy"] > 1.0
    assert not np.allclose(results[0][1], results[1][1])


def test_identical_input_matches_direct_forward(server):
    rgb = np.random.default_rng(7).integers(0, 255, (32, 64, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="PNG")
    _, _, raw = _post(f"http://127.0.0.1:{server.port}/predict", buf.getvalue())
    direct = server.batcher._predictor.predict(rgb[None].astype(np.float32) / 255.0)
    np.testing.assert_allclose(np.load(io.BytesIO(raw)), direct[0],
                               rtol=1e-5, atol=1e-5)


def test_server_u16_wire_formats(server, state_dict):
    from gdn_tpu_torch.server import DepthServer

    srv = DepthServer(TINY, state_dict, port=0, batch_size=4,
                      max_wait_ms=5.0, wire="u16", device="cpu")
    srv.start()
    try:
        base16 = f"http://127.0.0.1:{srv.port}"
        base32 = f"http://127.0.0.1:{server.port}"
        assert _get_json(f"{base16}/healthz")["wire"] == "u16"
        body = _png_bytes(32, 64, seed=11)
        _, _, raw32 = _post(f"{base32}/predict?format=png16", body)
        st, ct, raw16 = _post(f"{base16}/predict?format=png16", body)
        assert (st, ct) == (200, "image/png")
        a = np.asarray(Image.open(io.BytesIO(raw32))).astype(np.int64)
        b = np.asarray(Image.open(io.BytesIO(raw16))).astype(np.int64)
        assert np.abs(a - b).max() <= 1
        _, _, raw = _post(f"{base16}/predict", body)
        _, _, ref = _post(f"{base32}/predict", body)
        np.testing.assert_allclose(np.load(io.BytesIO(raw)),
                                   np.load(io.BytesIO(ref)), atol=1 / 256.0)
        st, _, raw = _post(f"{base16}/predict?format=color", body)
        assert st == 200 and Image.open(io.BytesIO(raw)).mode == "RGB"
        st, _, raw = _post(f"{base16}/predict", _png_bytes(40, 70, seed=12))
        assert np.load(io.BytesIO(raw)).shape == (40, 70)
    finally:
        srv.stop()


def test_serve_torch_cli_subprocess(tmp_path):
    """scripts/serve_torch.py end to end on the CPU at the KITTI preset's
    full size: boots, serves."""
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "scripts", "serve_torch.py"),
         "--init_random", "--device", "cpu", "--dtype", "float32",
         "--port", "0",
         "--serve_batch", "2", "--max_wait_ms", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(tmp_path),
    )
    try:
        line = ""
        deadline = time.time() + 120
        while time.time() < deadline:
            line = proc.stdout.readline()
            if "serving on" in line or proc.poll() is not None:
                break
        assert "serving on" in line, line + proc.stdout.read()
        port = int(line.split("http://127.0.0.1:")[1].split(" ")[0])
        assert _get_json(f"http://127.0.0.1:{port}/healthz")["status"] == "ok"
        st, _, raw = _post(f"http://127.0.0.1:{port}/predict",
                           _png_bytes(32, 64))
        assert st == 200 and np.load(io.BytesIO(raw)).shape == (32, 64)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)


# ------------------------------------------------------ import isolation

def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    # the port's scripts (export_torch.py and import_torch.py are the JAX
    # package's .pth converters)
    files += [os.path.join(REPO, "scripts", n) for n in os.listdir(os.path.join(REPO, "scripts"))
              if n.endswith("_torch.py") and n not in ("export_torch.py", "import_torch.py")]
    for root, _, names in os.walk(os.path.join(REPO, "gdn_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_port_sources_import_no_jax():
    files = _port_sources()
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_port_imports_with_jax_blocked():
    """Every module of the port imports in a process where the JAX
    stack and the JAX package cannot be imported at all."""
    code = (
        "import sys, pkgutil, importlib\n"
        f"for n in {FORBIDDEN!r}: sys.modules[n] = None\n"
        "import gdn_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    gdn_tpu_torch.__path__, 'gdn_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
