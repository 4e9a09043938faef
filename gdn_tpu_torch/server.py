"""HTTP inference server with dynamic request batching (port of
``gdn_tpu/server.py``; the HTTP contract is unchanged).

One predictor at a pinned batch size, fed by a dynamic batcher that
coalesces concurrent requests: the first request opens a window of
``max_wait_ms``; whatever arrives before it closes (capped at
``batch_size``) rides the same device batch.  Stdlib-only front end
(http.server + threads).  Endpoints:

  GET  /healthz          -> {"status": "ok", ...}
  GET  /stats            -> request/batch/occupancy/latency counters
  POST /predict?format=F -> depth for one PNG/JPEG body; F in
       npy (default, float32 meters, np.save bytes),
       png16 (16-bit PNG, depth*256 — the KITTI GT encoding),
       color (colorized PNG via ops/colormap).

Input images of any size are host-resized (PIL bilinear) to the model's
resolution and the depth map is resized back to the request's.  Inputs
travel to the device as uint8 (decoded there); ``wire="u16"`` fetches
depth as round(depth*256) uint16 counts.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
from PIL import Image

from gdn_tpu_torch.config import Config
from gdn_tpu_torch.serving import BatchedPredictor


class _Pending:
    """One in-flight request: input array + completion event."""

    __slots__ = ("rgb", "event", "depth", "error", "t_submit")

    def __init__(self, rgb: np.ndarray):
        self.rgb = rgb
        self.event = threading.Event()
        self.depth: Optional[np.ndarray] = None
        self.error: Optional[Exception] = None
        self.t_submit = time.perf_counter()


class DynamicBatcher:
    """Coalesces concurrent predict calls into fixed-size device batches.

    A single worker thread owns the predictor, so the device sees one
    stream of batches; callers block on a per-request event.  The
    predictor is built here, in the caller's thread, so its kernel
    library is loaded before the worker first launches it.
    """

    def __init__(self, cfg: Optional[Config], state_dict, batch_size: int = 8,
                 max_wait_ms: float = 5.0, *, timeout_s: float = 600.0,
                 predictor: Optional[BatchedPredictor] = None,
                 wire: str = "f32", device=None):
        self.cfg = cfg
        self._predictor = (
            predictor if predictor is not None
            else BatchedPredictor(cfg, state_dict, batch_size, device)
        )
        # D2H fetch format for every batch ("f32" meters | "u16"
        # depth*256 counts — half the fetch bytes, exact to 1/256 m;
        # with u16 the npy format returns the dequantized meters).
        self.wire = wire
        self.batch_size = self._predictor.batch_size
        self.max_wait_s = max_wait_ms / 1000.0
        self.timeout_s = timeout_s
        self._queue: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._stats_lock = threading.Lock()
        self._stopped = False
        self.stats = {
            "requests": 0,
            "errors": 0,
            "batches": 0,
            "batched_items": 0,
            "latency_ms_sum": 0.0,
        }
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def predict(self, rgb: np.ndarray,
                timeout: Optional[float] = None) -> np.ndarray:
        """rgb (H, W, 3) float32 [0,1] or uint8 [0,255] at model
        resolution -> depth (H, W): float32 meters, or uint16
        round(depth*256) counts under ``wire="u16"``.  Blocks until
        the batched result lands."""
        if self._stopped:
            raise RuntimeError("batcher is stopped")
        p = _Pending(rgb)
        self._queue.put(p)
        ok = p.event.wait(self.timeout_s if timeout is None else timeout)
        with self._stats_lock:
            self.stats["requests"] += 1
            if ok and p.error is None:
                self.stats["latency_ms_sum"] += (
                    time.perf_counter() - p.t_submit
                ) * 1000.0
            else:
                self.stats["errors"] += 1
        if not ok:
            raise TimeoutError("prediction timed out")
        if p.error is not None:
            raise p.error
        return p.depth

    def stop(self) -> None:
        # Requests racing this flag either see it (fail fast) or reach
        # the queue before the sentinel and are drained by _run's
        # shutdown path — never left to hang out the full timeout.
        self._stopped = True
        self._queue.put(None)
        self._worker.join(timeout=5.0)

    # -- worker ----------------------------------------------------------
    def _run(self) -> None:
        while True:
            first = self._queue.get()
            if first is None:
                self._drain()
                return
            batch = [first]
            deadline = time.perf_counter() + self.max_wait_s
            while len(batch) < self.batch_size:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._flush(batch)
                    self._drain()
                    return
                batch.append(nxt)
            self._flush(batch)

    def _drain(self) -> None:
        """Fail any request that slipped in behind the stop sentinel."""
        while True:
            try:
                p = self._queue.get_nowait()
            except queue.Empty:
                return
            if p is not None:
                p.error = RuntimeError("batcher is stopped")
                p.event.set()

    def _flush(self, batch) -> None:
        try:
            rgbs = np.stack([p.rgb for p in batch])
            depths = self._predictor.predict(rgbs, wire=self.wire)
            for p, d in zip(batch, depths):
                p.depth = d
        except Exception as e:  # noqa: BLE001 - surfaced to every caller
            for p in batch:
                p.error = e
        finally:
            with self._stats_lock:
                self.stats["batches"] += 1
                self.stats["batched_items"] += len(batch)
            for p in batch:
                p.event.set()


def _encode_depth(depth: np.ndarray, fmt: str, max_depth: float):
    """depth (H, W) float32 meters OR uint16 wire counts (depth*256,
    the ``--wire u16`` fetch format) -> (content_type, bytes)."""
    if depth.dtype == np.uint16 and fmt == "png16":
        # already the png16 payload — no conversion at all
        buf = io.BytesIO()
        Image.fromarray(depth, mode="I;16").save(buf, format="PNG")
        return "image/png", buf.getvalue()
    if depth.dtype == np.uint16:
        depth = depth.astype(np.float32) / 256.0  # counts -> meters
    if fmt == "npy":
        buf = io.BytesIO()
        np.save(buf, depth.astype(np.float32))
        return "application/octet-stream", buf.getvalue()
    if fmt == "png16":
        # KITTI GT encoding: uint16 PNG at depth*256 mm (data/kitti.py).
        # round (not truncate) — matches the device-side u16 wire.
        d16 = np.clip(np.round(depth * 256.0), 0, 65535).astype(np.uint16)
        buf = io.BytesIO()
        Image.fromarray(d16, mode="I;16").save(buf, format="PNG")
        return "image/png", buf.getvalue()
    if fmt == "color":
        from gdn_tpu_torch.ops.colormap import colorize_depth

        rgb = colorize_depth(depth, max_depth=max_depth)
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, format="PNG")
        return "image/png", buf.getvalue()
    raise ValueError(f"unknown format {fmt!r} (npy|png16|color)")


class DepthServer:
    """ThreadingHTTPServer wrapper around a DynamicBatcher."""

    def __init__(self, cfg: Optional[Config], state_dict=None,
                 host: str = "127.0.0.1", port: int = 0,
                 batch_size: int = 8, max_wait_ms: float = 5.0,
                 warmup: bool = True, timeout_s: float = 600.0,
                 predictor: Optional[BatchedPredictor] = None,
                 wire: str = "f32", device=None):
        """Either (cfg, state_dict) or a ready ``predictor`` (cfg
        optional then — only max_depth for color rendering is taken
        from it; colorize falls back to per-image normalization without
        it).  ``wire`` selects the device fetch format ("f32" | "u16",
        see DynamicBatcher); ``device`` defaults to CUDA."""
        self.cfg = cfg
        self.batcher = DynamicBatcher(
            cfg, state_dict, batch_size, max_wait_ms, timeout_s=timeout_s,
            predictor=predictor, wire=wire, device=device,
        )
        th, tw = self.batcher._predictor.image_size
        if warmup:
            # Warm up BEFORE accepting traffic so the first request
            # never pays cuDNN's algorithm search and the first
            # allocations inside its own latency budget.  Warm the
            # predictor directly (/stats latency must not fold the
            # warm-up in), on the SERVING path: uint8 input + the
            # configured wire.
            self.batcher._predictor.predict(
                np.zeros((1, th, tw, 3), np.uint8), wire=wire
            )
        max_depth = cfg.model.max_depth if cfg is not None else None
        batcher = self.batcher

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _json(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = urlparse(self.path).path
                if path == "/healthz":
                    self._json(200, {
                        "status": "ok",
                        "image_size": [th, tw],
                        "batch_size": batcher.batch_size,
                        "max_wait_ms": batcher.max_wait_s * 1000.0,
                        "wire": batcher.wire,
                    })
                elif path == "/stats":
                    with batcher._stats_lock:
                        s = dict(batcher.stats)
                    n = max(s["requests"], 1)
                    b = max(s["batches"], 1)
                    s["mean_latency_ms"] = s.pop("latency_ms_sum") / n
                    s["mean_batch_occupancy"] = s["batched_items"] / b
                    self._json(200, s)
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                parsed = urlparse(self.path)
                if parsed.path != "/predict":
                    self._json(404, {"error": "not found"})
                    return
                fmt = parse_qs(parsed.query).get("format", ["npy"])[0]
                if fmt not in ("npy", "png16", "color"):
                    # reject BEFORE decoding/batching: a bad format must
                    # not burn a device dispatch on a guaranteed 4xx.
                    self._json(400, {
                        "error": f"unknown format {fmt!r} (npy|png16|color)"
                    })
                    return
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    img = Image.open(
                        io.BytesIO(self.rfile.read(length))
                    ).convert("RGB")
                except Exception as e:  # noqa: BLE001
                    self._json(400, {"error": f"bad image: {e}"})
                    return
                w0, h0 = img.size
                # uint8 straight through: the /255 decode runs on
                # device (serving._prep_rgb) — 1/4 the upload bytes.
                x = np.asarray(img.resize((tw, th), Image.BILINEAR),
                               np.uint8)
                try:
                    depth = batcher.predict(x)
                    if (h0, w0) != (th, tw):
                        if depth.dtype == np.uint16:  # u16 wire: bytes
                            # already saved; resize in meters
                            depth = depth.astype(np.float32) / 256.0
                        depth = np.asarray(Image.fromarray(depth).resize(
                            (w0, h0), Image.BILINEAR
                        ))
                    ctype, body = _encode_depth(depth, fmt, max_depth)
                except Exception as e:  # noqa: BLE001
                    self._json(500, {"error": repr(e)})
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        """Serve in a background thread (returns immediately)."""
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._thread.start()

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self.batcher.stop()
