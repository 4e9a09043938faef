#!/usr/bin/env python3
"""On-card smoke check of the PyTorch/CUDA port (gdn_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
repository around this file.  Phases, each printed on its own lines:

  1. device   the card's name and power limit (nvidia-smi);
  2. build    the kernel built from gdn_tpu_torch/csrc with nvcc;
  3. kernels  at every (B=8, C, H, W, groups) shape the KITTI serving
              forward gives the GroupNorm+ELU kernel, in bf16 and fp32:
              kernel vs its plain PyTorch version on the same tensors,
              with the kernel's, the plain version's and the library
              yardstick's (F.group_norm + F.elu) times and the bound;
  4. slice    the full-width KITTI G-net (random weights from seed 0,
              batch 8, bf16) serves 20 uint8 images through
              BatchedPredictor; the kernel must launch 21 times a batch;
              depth is checked against the same weights run on the CPU;
  5. server   DepthServer answers 3 concurrent POSTs (npy, png16,
              color) and /stats.

Any failure ends the run with a nonzero exit.  The last lines are the
kernels' JSON line, the nvidia-smi line, and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Per-shape numbers also go to smoke_out/chip_smoke.json, the serving
profile to smoke_out/serving_profile.txt.
"""

import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "smoke_out")  # gitignored
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS = 67e12  # H100 SXM, outside the tensor cores
L2_BYTES = 50 * 2**20
GN_FLOPS_PER_ELEM = 8  # sum, square-sum, center, scale, shift, ELU
TOL = {torch.bfloat16: (0.05, 0.05), torch.float32: (1e-4, 1e-5)}  # rtol, atol
BATCH = 8


def log(msg):
    print(msg, flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fns, iters=20):
    """Mean ms of one call, cycling through ``fns`` (distinct inputs, so
    that together they overflow the L2 cache as a real caller's would)."""
    for f in fns[:3]:
        f()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    n = max(iters, len(fns))
    start.record()
    for i in range(n):
        fns[i % len(fns)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _device_us(prof):
    """{kernel name: (device us, calls)} of a torch.profiler run: the
    kernels' own rows only (an operator's row repeats its kernels' time)."""
    from torch.autograd import DeviceType

    return {e.key: (e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def device_ms(fns, iters=20):
    """Mean device ms of one call, from the profiler: the sum of the
    card's kernel times over a loop, whatever the host's pace.  Raises
    when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    for f in fns[:3]:
        f()
    torch.cuda.synchronize()
    n = max(iters, len(fns))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fns[i % len(fns)]()
        torch.cuda.synchronize()
    total_us = sum(us for us, _ in _device_us(prof).values())
    if total_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return total_us / 1e3 / n


def gn_sites(m):
    """(C, H, W) of every GroupNorm+ELU site of one RtoDNet forward, in
    order: the stem, two per DownBlock, two per UpBlock (up + fuse)."""
    h, w = m.image_size
    sites, sizes = [(m.enc_channels[0], h, w)], [(h, w)]
    for ch in m.enc_channels:
        h, w = -(-h // 2), -(-w // 2)  # SAME stride 2
        sites += [(ch, h, w)] * 2
        sizes.append((h, w))
    n = len(m.enc_channels)
    for i, ch in enumerate(m.dec_channels):
        sites += [(ch, *sizes[n - 1 - i])] * 2  # skips fine->coarse
    return sites


def check_close(got, want, dtype, what):
    rtol, atol = TOL[dtype]
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if bad.any() or not torch.isfinite(got).all():
        raise AssertionError(
            f"{what}: {int(bad.sum())} elements beyond rtol {rtol} atol {atol}"
            f" (max abs err {err.max().item():.3g})"
        )
    return err.max().item()


def phase_kernels(cfg, gn):
    from gdn_tpu_torch.ops.groupnorm import group_norm_elu_plain, pick_groups

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for c, h, w in sorted(set(gn_sites(cfg.model)), reverse=True):
        g = pick_groups(c, cfg.model.group_norm_groups)
        count = gn_sites(cfg.model).count((c, h, w))
        for dtype in (torch.bfloat16, torch.float32):
            shape = (BATCH, c, h, w)
            numel = BATCH * c * h * w
            nbytes = 2 * numel * torch.finfo(dtype).bits // 8 + 2 * c * 4
            copies = max(1, -(-2 * L2_BYTES // nbytes))
            xs = [
                (torch.randn(shape, device="cuda", generator=gen) * 2 + 1)
                .to(dtype).contiguous(memory_format=torch.channels_last)
                for _ in range(copies)
            ]
            scale = torch.rand(c, device="cuda", generator=gen) + 0.5
            bias = torch.randn(c, device="cuda", generator=gen)
            out = gn(xs[0], scale, bias, g)
            torch.cuda.synchronize()
            ref = group_norm_elu_plain(xs[0], scale, bias, g)
            what = f"group_norm_elu {tuple(shape)} {dtype}"
            err = check_close(out, ref, dtype, what)
            sc, bi = scale.to(dtype), bias.to(dtype)
            fns = {
                "": [lambda x=x: gn(x, scale, bias, g) for x in xs],
                "plain_": [lambda x=x: group_norm_elu_plain(x, scale, bias, g)
                           for x in xs],
                "library_": [lambda x=x: F.elu(F.group_norm(x, g, sc, bi, 1e-6))
                             for x in xs],
            }
            row = {
                "C": c, "H": h, "W": w, "groups": g, "dtype": str(dtype),
                "sites": count, "max_abs_err": err, "bytes": nbytes,
                "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                      GN_FLOPS_PER_ELEM * numel / FP32_FLOPS),
            }
            for k, f in fns.items():
                # ms: device time (the card's own, from the profiler);
                # call_ms: CUDA events around a loop of calls, host-bound
                # where the wrapper's Python outlasts the kernels.
                row[f"{k}ms"] = device_ms(f)
                row[f"{k}call_ms"] = cuda_ms(f)
            rows.append(row)
            log(f"  {what}: max|k-p| {err:.3g}  device us: kernel "
                f"{row['ms']*1e3:.1f} plain {row['plain_ms']*1e3:.1f} "
                f"library {row['library_ms']*1e3:.1f} bound "
                f"{row['bound_ms']*1e3:.1f}; per call us: kernel "
                f"{row['call_ms']*1e3:.1f} plain {row['plain_call_ms']*1e3:.1f}"
                f" library {row['library_call_ms']*1e3:.1f}  x{count} sites")
            del xs
    return rows


def phase_slice(cfg, sd, gn):
    from gdn_tpu_torch.config import _with
    from gdn_tpu_torch.serving import BatchedPredictor

    h, w = cfg.model.image_size
    images = np.random.default_rng(0).integers(0, 256, (20, h, w, 3), np.uint8)
    pred = BatchedPredictor(cfg, sd, batch_size=BATCH)
    pred.predict(images[:BATCH])  # warm-up: cuDNN algorithm search
    torch.cuda.synchronize()
    gn.launches = 0
    depth = pred.predict(images)
    launches = gn.launches
    batches = -(-len(images) // BATCH)
    log(f"  20 images in {batches} batches: {launches} GN+ELU launches")
    if depth.shape != (20, h, w):
        raise AssertionError(f"depth shape {depth.shape}")
    if not (np.isfinite(depth).all() and (depth > 0).all()
            and (depth <= cfg.model.max_depth).all()):
        raise AssertionError("depth not finite in (0, max_depth]")
    if launches != len(gn_sites(cfg.model)) * batches:
        raise AssertionError(f"{launches} launches, expected 21 x {batches}")

    # The same weights in fp32 on the CPU: the card's fp32 path (TF32
    # off) must agree to rtol 1e-4 / atol 1e-3 m, its bf16 path within
    # 2 m max and 0.4 m mean (2.5% / 0.5% of 80 m; bf16 vs fp32 through
    # 21 layers of this random net measured 0.95 m max, 0.12 m mean on
    # the CPU).
    cf = _with(cfg, **{"model.dtype": "float32"})
    cpu = BatchedPredictor(cf, sd, batch_size=2, device="cpu").predict(images[:2])
    gpu32 = BatchedPredictor(cf, sd, batch_size=2).predict(images[:2])
    np.testing.assert_allclose(gpu32, cpu, rtol=1e-4, atol=1e-3)
    d = np.abs(depth[:2] - cpu)
    log(f"  vs CPU fp32: card fp32 max|d| {np.abs(gpu32 - cpu).max():.3g} m;"
        f" card bf16 max|d| {d.max():.3g} m, mean {d.mean():.3g} m")
    if d.max() > 2.0 or d.mean() > 0.4:
        raise AssertionError("bf16 depth beyond the stated bound")

    many = np.concatenate([images] * 4)[:64]
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        pred.predict(many)
        times.append(time.perf_counter() - t0)
    t = min(times)
    ms_batch = 1e3 * t / (len(many) // BATCH)
    log(f"  serving: {ms_batch:.2f} ms/batch of {BATCH}, "
        f"{len(many) / t:.1f} images/s (64 images, best of 3)")
    profile = profile_serving(pred, many)
    return pred, launches, {"ms_per_batch": ms_batch,
                            "images_per_s": len(many) / t,
                            "launches_per_batch": launches / batches,
                            "profile": profile}


def profile_serving(pred, images):
    """Where one serving call's time goes: the card's busy share of the
    wall time, and its kernels by device time (table in OUT)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.predict(images)
        wall = time.perf_counter() - t0
    kernels = _device_us(prof)
    busy_ms = sum(us for us, _ in kernels.values()) / 1e3
    gn_ms = sum(us for k, (us, _) in kernels.items()
                if "gn_stats" in k or "gn_apply" in k) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "serving_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=40))
    out = {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
           "idle_share": 1 - busy_ms / (wall * 1e3), "gn_elu_device_ms": gn_ms,
           "top_kernels_us": [(k[:90], us, n) for k, (us, n) in top]}
    log(f"  profile of {len(images)} images: wall {out['wall_ms']:.1f} ms, "
        f"device busy {busy_ms:.2f} ms (idle {out['idle_share']:.1%}), "
        f"GN+ELU kernels {gn_ms:.3f} ms")
    for k, us, n in out["top_kernels_us"]:
        log(f"    {us/1e3:8.3f} ms  x{n:<5d} {k}")
    return out


def phase_server(cfg, pred):
    from PIL import Image

    from gdn_tpu_torch.server import DepthServer

    srv = DepthServer(cfg, predictor=pred, port=0, max_wait_ms=20.0)
    srv.start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        jobs = [((128, 416), "npy"), ((200, 640), "png16"), ((90, 300), "color")]
        results = [None] * len(jobs)

        def post(i):
            (h, w), fmt = jobs[i]
            rgb = np.random.default_rng(i).integers(0, 255, (h, w, 3), np.uint8)
            buf = io.BytesIO()
            Image.fromarray(rgb).save(buf, format="PNG")
            req = urllib.request.Request(f"{base}/predict?format={fmt}",
                                         data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                results[i] = (r.status, r.read())

        threads = [threading.Thread(target=post, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        for ((h, w), fmt), res in zip(jobs, results):
            if res is None or res[0] != 200:
                raise AssertionError(f"POST {fmt} {h}x{w}: {res}")
            if fmt == "npy":
                arr = np.load(io.BytesIO(res[1]))
                ok = arr.shape == (h, w) and np.isfinite(arr).all()
            else:
                img = Image.open(io.BytesIO(res[1]))
                ok = img.size == (w, h) and img.mode == ("RGB" if fmt == "color"
                                                         else img.mode)
            if not ok:
                raise AssertionError(f"POST {fmt} {h}x{w}: bad payload")
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            stats = json.loads(r.read())
        if stats["requests"] != 3 or stats["errors"] != 0:
            raise AssertionError(f"/stats {stats}")
        log(f"  3 concurrent POSTs answered; /stats {stats}")
    finally:
        srv.stop()


def main():
    log("== 1. device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from gdn_tpu_torch.checkpoint import init_params
    from gdn_tpu_torch.config import kitti_config
    from gdn_tpu_torch.kernels import groupnorm as gnk

    # fp32 results are compared with the CPU: no TF32 anywhere
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = smi_line()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"  {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    log("== 2. build")
    t0 = time.perf_counter()
    gnk.load()
    log(f"  group_norm_elu built and loaded in {time.perf_counter() - t0:.2f} s")

    cfg = kitti_config(**{"model.use_pallas_gn": True})
    gn = gnk.group_norm_elu
    log("== 3. kernels vs plain (B=8, KITTI serving shapes)")
    rows = phase_kernels(cfg, gn)

    log("== 4. slice: BatchedPredictor, full-width KITTI G-net, bf16")
    sd = init_params(cfg.model, torch.Generator().manual_seed(0))
    pred, launches, serving = phase_slice(cfg, sd, gn)

    log("== 5. server")
    phase_server(cfg, pred)

    main_rows = [r for r in rows if r["dtype"] == str(torch.bfloat16)]
    per_fwd = {k: sum(r[k] * r["sites"] for r in main_rows)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    kernels = [{
        "name": "group_norm_elu",
        "route": "cuda",
        "source": "gdn_tpu_torch/csrc/group_norm_elu.cu",
        "replaces": "gdn_tpu/kernels/groupnorm.py:133",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in main_rows),
        **per_fwd,
        "bound_by": "bytes",
    }]
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "chip_smoke.json"), "w") as f:
        json.dump({"device": smi, "torch": torch.__version__,
                   "per_shape": rows, "serving": serving,
                   "kernels": kernels}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
