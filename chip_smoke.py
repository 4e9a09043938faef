#!/usr/bin/env python3
"""On-card smoke check of the PyTorch/CUDA port (gdn_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
repository around this file.  Phases, each printed on its own lines:

  1. device   the card's name and power limit (nvidia-smi);
  2. build    both kernel libraries from gdn_tpu_torch/csrc, one nvcc
              each, started together;
  3. kernels  at every (B=8, C, H, W, groups) shape the KITTI serving
              forward gives the GroupNorm+ELU kernel, in bf16 and fp32:
              kernel vs its plain PyTorch version on the same tensors,
              with the kernel's, the plain version's and the library
              yardstick's (F.group_norm + F.elu) times and the bound;
              then at every training shape (B=32, bf16), the same check;
  4. slice    the full-width KITTI G-net (random weights from seed 0,
              batch 8, bf16) serves 20 uint8 images through
              BatchedPredictor; the kernel must launch 21 times a batch;
              depth is checked against the same weights run on the CPU;
  5. server   DepthServer answers 3 concurrent POSTs (npy, png16,
              color) and /stats;
  6. loss     the fused loss forward and backward kernels vs their plain
              versions at B=32 128x416 (synthetic depth, ~5% holes, one
              all-masked image) and at ragged 3x37x53 and 2x11x16, with
              device times and bounds;
  7. gn grad  GroupNorm+ELU gradients (x, scale, bias) through the
              kernel's autograd Function vs plain autograd, 3 serving
              shapes and the largest training one (32, 32, 128, 416);
  8. train    train_stage1 then train_stage2, 21 steps each, full-width
              KITTI, bf16, B=32, synthetic data on the card: finite
              losses, moved encoders, a bit-identical frozen decoder and
              D-net, the launches per step; ms/step and images/s; a
              profile of one stage-2 step;
  9. vs CPU   one stage-2 step at B=2, fp32, TF32 off: loss terms and
              gradients against the same step on the CPU; the card's
              bf16 loss terms against CPU fp32.

Any failure ends the run with a nonzero exit.  The last lines are the
kernels' JSON line, the nvidia-smi line, and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Per-shape numbers also go to smoke_out/chip_smoke.json, the profiles to
smoke_out/serving_profile.txt and smoke_out/training_profile.txt.
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
TRAIN_BATCH = 32  # DataConfig.batch_size
TRAIN_STEPS = 21  # the host clock times steps 2-21
# Fused loss operation counts per pixel for an 11-tap window, the least
# the algorithm needs: forward = 3 products + 5 moments x 2 passes x 11
# taps x 2 + ~20 for the SSIM map + 16 for L1 and the two differences +
# 2 normalizations; backward = the same moments (225) + ~35 for the map
# and the three adjoint maps + 3 maps x 2 passes x 11 taps x 2 for the
# transposed blur + ~35 for the sign fields and the final sum.
LOSS_FWD_FLOPS_PX = 3 + 5 * 2 * 11 * 2 + 20 + 16 + 2
LOSS_BWD_FLOPS_PX = 225 + 35 + 3 * 2 * 11 * 2 + 35
LOSS_FWD_BYTES_PX = 12  # pred, gt, mask read (fp32)
LOSS_BWD_BYTES_PX = 16  # the same, plus dpred written


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
    kernels' own rows only (an operator's row repeats its kernels' time,
    and so does a user annotation such as Adam's step)."""
    from torch.autograd import DeviceType

    return {e.key: (e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)}


def profiled(run, cpu=False, tries=3):
    """(profiler, {kernel: (us, calls)}, wall s) of ``run()`` under
    torch.profiler.  CUPTI has on the H100 handed back, rarely, a
    session with no device rows at all; such a session is run again, up
    to ``tries`` in all, and the run fails if every one came back empty."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = _device_us(prof)
        if kernels:
            return prof, kernels, wall
        log(f"  (profiler session {attempt} of {tries} recorded no device time)")
    raise RuntimeError(f"torch.profiler recorded no device time in {tries} sessions")


def device_ms(fns, iters=20):
    """Mean device ms of one call, from the profiler: the sum of the
    card's kernel times over a loop, whatever the host's pace."""
    for f in fns[:3]:
        f()
    n = max(iters, len(fns))

    def loop():
        for i in range(n):
            fns[i % len(fns)]()

    _, kernels, _ = profiled(loop)
    return sum(us for us, _ in kernels.values()) / 1e3 / n


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
    return check_tol(got, want, *TOL[dtype], what)


def check_tol(got, want, rtol, atol, what):
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


def phase_kernels_train(cfg, gn):
    """The kernel vs its plain version at every site the stage-1 D-net
    and stage-2 G-net give it in training (B=32, bf16; both nets have
    the same 21 sites), at the same tolerance; with the kernel's device
    time and bound per site."""
    from gdn_tpu_torch.ops.groupnorm import group_norm_elu_plain, pick_groups

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(4)
    dtype = torch.bfloat16
    for c, h, w in sorted(set(gn_sites(cfg.model)), reverse=True):
        g = pick_groups(c, cfg.model.group_norm_groups)
        shape = (TRAIN_BATCH, c, h, w)
        x = ((torch.randn(shape, device="cuda", generator=gen) * 2 + 1)
             .to(dtype).contiguous(memory_format=torch.channels_last))
        scale = torch.rand(c, device="cuda", generator=gen) + 0.5
        bias = torch.randn(c, device="cuda", generator=gen)
        out = gn(x, scale, bias, g)
        torch.cuda.synchronize()
        what = f"group_norm_elu {shape} {dtype}"
        err = check_close(out, group_norm_elu_plain(x, scale, bias, g), dtype, what)
        nbytes = 2 * x.numel() * x.element_size() + 2 * c * 4
        row = {"B": TRAIN_BATCH, "C": c, "H": h, "W": w, "groups": g,
               "dtype": str(dtype), "max_abs_err": err,
               "ms": device_ms([lambda: gn(x, scale, bias, g)]),
               "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                     GN_FLOPS_PER_ELEM * x.numel() / FP32_FLOPS)}
        rows.append(row)
        log(f"  {what}: max|k-p| {err:.3g}  device us: kernel "
            f"{row['ms']*1e3:.1f} bound {row['bound_ms']*1e3:.1f}")
        del x, out
    return rows


def reset_counts():
    from gdn_tpu_torch.kernels import fused_loss as fl
    from gdn_tpu_torch.kernels import groupnorm as gnk

    gnk.group_norm_elu.launches = 0
    fl.fused_loss_fwd.launches = 0
    fl.fused_loss_bwd.launches = 0


def read_counts():
    from gdn_tpu_torch.kernels import fused_loss as fl
    from gdn_tpu_torch.kernels import groupnorm as gnk

    return {"group_norm_elu": gnk.group_norm_elu.launches,
            "fused_loss_fwd": fl.fused_loss_fwd.launches,
            "fused_loss_bwd": fl.fused_loss_bwd.launches}


def phase_slice(cfg, sd, gn):
    from gdn_tpu_torch.config import _with
    from gdn_tpu_torch.serving import BatchedPredictor

    h, w = cfg.model.image_size
    images = np.random.default_rng(0).integers(0, 256, (20, h, w, 3), np.uint8)
    pred = BatchedPredictor(cfg, sd, batch_size=BATCH)
    pred.predict(images[:BATCH])  # warm-up: cuDNN algorithm search
    torch.cuda.synchronize()
    reset_counts()
    depth = pred.predict(images)
    launches = read_counts()["group_norm_elu"]
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
    prof, kernels, wall = profiled(lambda: pred.predict(images), cpu=True)
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


def _loss_inputs(b, h, w, copies, gen):
    """Synthetic GT depth and mask (~5% holes, the last image all
    masked) and a prediction with continuous noise on top (no ties)."""
    from gdn_tpu_torch.data.synthetic import synthetic_batch

    out = []
    for _ in range(copies):
        batch = synthetic_batch(gen, b, h, w, 80.0)
        gt = batch["depth"][..., 0].contiguous()
        mask = batch["mask"][..., 0].contiguous()
        mask[-1] = 0.0
        noise = torch.randn(gt.shape, device="cuda", generator=gen)
        pred = torch.clamp(gt * (1 + 0.1 * noise), 0.5, 80.0).contiguous()
        out.append((pred, gt, mask))
    return out


def phase_loss():
    """Both loss kernels vs their plain versions.  Sums: rtol 1e-5 (the
    JAX suite's value bound) on the counts' and sums' scale, atol 1e-6.
    dpred: rtol 2e-4 (the JAX suite's gradient bound) plus an absolute
    floor of 1e-5 of the largest |dpred| (the per-image cotangents are
    ~1/N, and elements near 0 see the adjoint's cancellations)."""
    from gdn_tpu_torch.kernels import fused_loss as fl

    gen = torch.Generator(device="cuda").manual_seed(1)
    ct = torch.tensor([1.0, 1.0, 0.5], device="cuda")  # w_recon, w_grad, w_ssim
    rows = []
    for b, h, w in [(TRAIN_BATCH, 128, 416), (3, 37, 53), (2, 11, 16)]:
        main = b == TRAIN_BATCH
        ins = _loss_inputs(b, h, w, 3 if main else 1, gen)
        pred, gt, mask = ins[0]
        raw = fl.fused_loss_fwd(pred, gt, mask, 80.0)
        ref = fl.loss_sums_plain(pred, gt, mask, 80.0)
        fwd_err = check_tol(raw, ref, 1e-5, 1e-6, f"fused_loss_fwd {b}x{h}x{w}")
        cts = fl._cotangents(ref, ct)
        d = fl.fused_loss_bwd(pred, gt, mask, cts, 80.0)
        dref = fl.fused_loss_bwd_plain(pred, gt, mask, cts, 80.0)
        torch.cuda.synchronize()
        floor = 1e-5 * dref.abs().max().item()
        bwd_err = check_tol(d, dref, 2e-4, floor, f"fused_loss_bwd {b}x{h}x{w}")
        row = {"B": b, "H": h, "W": w, "fwd_max_abs_err": fwd_err,
               "fwd_max_rel_err": ((raw - ref).abs() / ref.abs().clamp(min=1e-30)).max().item(),
               "bwd_max_abs_err": bwd_err, "bwd_max_abs_ref": dref.abs().max().item()}
        log(f"  {b}x{h}x{w}: sums max|k-p| {fwd_err:.3g} (rel "
            f"{row['fwd_max_rel_err']:.3g}); dpred max|k-p| {bwd_err:.3g} of "
            f"max|p| {row['bwd_max_abs_ref']:.3g}")
        if main:
            px = b * h * w
            row["fwd_bound_ms"] = 1e3 * max(LOSS_FWD_BYTES_PX * px / HBM_BYTES_PER_S,
                                            LOSS_FWD_FLOPS_PX * px / FP32_FLOPS)
            row["bwd_bound_ms"] = 1e3 * max(LOSS_BWD_BYTES_PX * px / HBM_BYTES_PER_S,
                                            LOSS_BWD_FLOPS_PX * px / FP32_FLOPS)
            fns = {
                "fwd_ms": [lambda i=i: fl.fused_loss_fwd(*i, 80.0) for i in ins],
                "fwd_plain_ms": [lambda i=i: fl.loss_sums_plain(*i, 80.0) for i in ins],
                "bwd_ms": [lambda i=i: fl.fused_loss_bwd(*i, cts, 80.0) for i in ins],
                "bwd_plain_ms": [lambda i=i: fl.fused_loss_bwd_plain(*i, cts, 80.0)
                                 for i in ins],
            }
            for k, f in fns.items():
                row[k] = device_ms(f)
            log(f"  device us at B={b}: forward kernel {row['fwd_ms']*1e3:.1f} "
                f"plain {row['fwd_plain_ms']*1e3:.1f} bound "
                f"{row['fwd_bound_ms']*1e3:.2f} (operations); backward kernel "
                f"{row['bwd_ms']*1e3:.1f} plain {row['bwd_plain_ms']*1e3:.1f} "
                f"bound {row['bwd_bound_ms']*1e3:.2f} (operations)")
        rows.append(row)
    return rows


def phase_gn_grad():
    """dx, dscale, dbias through the kernel's autograd Function vs plain
    autograd of group_norm_elu_plain.  fp32: rtol 1e-4 / atol 1e-5.
    bf16: dx at the forward's 0.05 / 0.05; dscale and dbias, sums over
    B*H*W bf16 terms that the plain graph rounds at other places, within
    2% of their largest magnitude."""
    from gdn_tpu_torch.kernels.groupnorm import group_norm_elu
    from gdn_tpu_torch.ops.groupnorm import group_norm_elu_plain

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for b, c, h, w in [(BATCH, 32, 128, 416), (BATCH, 128, 16, 52), (BATCH, 512, 4, 13),
                       (TRAIN_BATCH, 32, 128, 416)]:
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn((b, c, h, w), device="cuda", generator=gen) * 2 + 1
                 ).to(dtype).contiguous(memory_format=torch.channels_last)
            da = torch.randn(x.shape, device="cuda", generator=gen).to(dtype).contiguous(
                memory_format=torch.channels_last)
            sc = torch.rand(c, device="cuda", generator=gen) + 0.5
            bi = torch.randn(c, device="cuda", generator=gen)
            grads = []
            for fn in (group_norm_elu, group_norm_elu_plain):
                xi, si, bii = (t.clone().requires_grad_(True) for t in (x, sc, bi))
                out = fn(xi, si, bii, 8)
                if out.grad_fn is None:
                    raise AssertionError("group_norm_elu output has no grad_fn")
                grads.append(torch.autograd.grad(out, (xi, si, bii), da))
            what = f"gn grad {(b, c, h, w)} {dtype}"
            errs = [check_close(grads[0][0], grads[1][0], dtype, f"{what} dx")]
            for name, got, want in zip(("dscale", "dbias"), grads[0][1:], grads[1][1:]):
                if dtype == torch.float32:
                    errs.append(check_close(got, want, dtype, f"{what} {name}"))
                else:
                    errs.append(check_tol(got, want, 0.0, 0.02 * want.abs().max().item(),
                                          f"{what} {name}"))
            rows.append({"B": b, "C": c, "H": h, "W": w, "dtype": str(dtype),
                         "max_abs_err_dx_dscale_dbias": errs,
                         "max_abs_ref_dx_dscale_dbias":
                             [g.abs().max().item() for g in grads[1]]})
            log(f"  {what}: max|k-p| dx {errs[0]:.3g} dscale {errs[1]:.3g} "
                f"dbias {errs[2]:.3g}")
    return rows


def phase_train(cfg):
    from gdn_tpu_torch.checkpoint import init_params, load_pth
    from gdn_tpu_torch.config import _with
    from gdn_tpu_torch.data.synthetic import SyntheticDataset
    from gdn_tpu_torch.models import DtoDNet
    from gdn_tpu_torch.train.loop import train_stage1, train_stage2
    from gdn_tpu_torch.utils.logging import MetricLogger

    ckpt = os.path.join(OUT, "train")
    cfg = _with(cfg, **{"train.steps_per_epoch": TRAIN_STEPS,
                        "train.log_every": TRAIN_STEPS, "train.ckpt_dir": ckpt,
                        "data.batch_size": TRAIN_BATCH})
    h, w = cfg.model.image_size
    data = iter(SyntheticDataset(TRAIN_BATCH, h, w, cfg.model.max_depth, seed=0,
                                 device="cuda"))
    sites = len(gn_sites(cfg.model))
    out, launches = {}, {}
    for stage in ("stage1", "stage2"):
        jsonl = os.path.join(OUT, f"train_{stage}.jsonl")
        if os.path.exists(jsonl):
            os.remove(jsonl)
        logger = MetricLogger(prefix=stage, jsonl_path=jsonl)
        torch.cuda.synchronize()
        reset_counts()
        if stage == "stage1":
            s1 = train_stage1(cfg, data, epochs=1, logger=logger)
        else:
            d_net = DtoDNet(cfg.model)
            d_net.load_state_dict(load_pth(os.path.join(ckpt, "stage1.pth")))
            d_net = d_net.cuda()
            d_before = {k: v.clone() for k, v in d_net.state_dict().items()}
            s2 = train_stage2(cfg, data, d_net, epochs=1, logger=logger)
        torch.cuda.synchronize()
        launches[stage] = counts = read_counts()
        logger.close()
        rec = [json.loads(line) for line in open(jsonl)][-1]
        want = {"group_norm_elu": sites * (1 if stage == "stage1" else 2) * TRAIN_STEPS,
                "fused_loss_fwd": TRAIN_STEPS, "fused_loss_bwd": TRAIN_STEPS}
        if counts != want:
            raise AssertionError(f"{stage} launches {counts}, expected {want}")
        terms = {k: v for k, v in rec.items() if k not in ("t", "step", "imgs_per_sec")}
        if not all(np.isfinite(v) for v in terms.values()):
            raise AssertionError(f"{stage} loss not finite: {rec}")
        ips = rec["imgs_per_sec"]
        out[stage] = {"images_per_s": ips, "ms_per_step": 1e3 * TRAIN_BATCH / ips,
                      "last_terms": terms, "launches": counts}
        log(f"  {stage}: {TRAIN_STEPS} steps, launches {counts}; "
            f"{out[stage]['ms_per_step']:.1f} ms/step, {ips:.1f} images/s "
            f"(host clock, steps 2-{TRAIN_STEPS}); last terms "
            + " ".join(f"{k}={v:.4f}" for k, v in terms.items()))

    # encoders moved; the frozen decoder is stage 1's; the D-net untouched
    gen = torch.Generator()
    for st, ch in ((s1, 1), (s2, 3)):
        init = init_params(cfg.model, gen.manual_seed(cfg.train.seed), in_channels=ch)
        k = "encoder.stem.Conv_0.kernel"
        if torch.equal(st.net.state_dict()[k].cpu(), init[k]):
            raise AssertionError(f"{k} did not move (in_channels={ch})")
    for k, v in s2.net.decoder.state_dict().items():
        if not torch.equal(v, d_before[f"decoder.{k}"]):
            raise AssertionError(f"frozen decoder changed at {k}")
    for k, v in d_net.state_dict().items():
        if not torch.equal(v, d_before[k]):
            raise AssertionError(f"D-net changed at {k}")
    log("  encoders moved; frozen decoder and D-net bit-identical")
    out["profile"] = profile_train_step(cfg, s2, d_net, next(data))
    return out, launches, s1, s2, d_net


def profile_train_step(cfg, state, d_net, batch):
    """One stage-2 step under torch.profiler: the card's busy share of
    the wall time and its kernels by device time (table in OUT)."""
    from gdn_tpu_torch.train.steps import make_stage2_step

    step = make_stage2_step(cfg)
    step(state, d_net, batch)
    prof, kernels, wall = profiled(lambda: step(state, d_net, batch), cpu=True)
    busy_ms = sum(us for us, _ in kernels.values()) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    with open(os.path.join(OUT, "training_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=50))
    out = {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
           "idle_share": 1 - busy_ms / (wall * 1e3), "kernel_launches":
           sum(n for _, n in kernels.values()),
           "top_kernels_us": [(k[:90], us, n) for k, (us, n) in top]}
    log(f"  profile of one stage-2 step: wall {out['wall_ms']:.1f} ms, device "
        f"busy {busy_ms:.2f} ms (idle {out['idle_share']:.1%}), "
        f"{out['kernel_launches']} kernel launches")
    for k, us, n in out["top_kernels_us"]:
        log(f"    {us/1e3:8.3f} ms  x{n:<5d} {k}")
    return out


def phase_vs_cpu(cfg, s2, d_net):
    """One stage-2 step at B=2, full width: the card (fp32, TF32 off)
    against the CPU (fp32) on the same weights and batch.  Loss terms:
    rtol 1e-4.  Gradients of the stem conv kernel and the stem GN scale:
    within 1e-3 of their largest magnitude (fp32 through ~40 layers of
    forward and backward, summed in other orders by cuDNN and by the
    CPU).  The card's bf16 terms against CPU fp32: within 5% each
    (bf16 keeps 8 bits of mantissa at every layer)."""
    from gdn_tpu_torch.config import _with
    from gdn_tpu_torch.data.synthetic import synthetic_batch
    from gdn_tpu_torch.models import DtoDNet, RtoDNet
    from gdn_tpu_torch.train.steps import _stage2_loss

    g_sd = {k: v.detach().cpu() for k, v in s2.net.state_dict().items()}
    d_sd = {k: v.detach().cpu() for k, v in d_net.state_dict().items()}
    batch = synthetic_batch(torch.Generator().manual_seed(3), 2,
                            *cfg.model.image_size, cfg.model.max_depth)
    watch = ("encoder.stem.Conv_0.kernel", "encoder.stem.gn_scale")
    res = {}
    for name, dtype, dev in (("cpu", "float32", "cpu"), ("card32", "float32", "cuda"),
                             ("card16", "bfloat16", "cuda")):
        c = _with(cfg, **{"model.dtype": dtype})
        g, d = RtoDNet(c.model), DtoDNet(c.model)
        g.load_state_dict(g_sd)
        d.load_state_dict(d_sd)
        g, d = g.to(dev), d.to(dev).requires_grad_(False)
        g.decoder.requires_grad_(False)
        terms = _stage2_loss(g, d, {k: v.to(dev) for k, v in batch.items()}, c)
        terms["total"].backward()
        params = dict(g.named_parameters())
        res[name] = ({k: float(v.detach()) for k, v in terms.items()},
                     {k: params[k].grad.detach().cpu() for k in watch})
    out = {"terms": {k: v[0] for k, v in res.items()}}
    cpu_t, cpu_g = res["cpu"]
    for k, v in res["card32"][0].items():
        if abs(v - cpu_t[k]) > 1e-4 * abs(cpu_t[k]):
            raise AssertionError(f"card fp32 {k}={v} vs CPU {cpu_t[k]}")
    for k in watch:
        got, want = res["card32"][1][k], cpu_g[k]
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        out[f"grad_rel_err {k}"] = err / scale
        if err > 1e-3 * scale:
            raise AssertionError(f"card fp32 grad {k}: max|d| {err:.3g} of {scale:.3g}")
    rel16 = {k: abs(v - cpu_t[k]) / abs(cpu_t[k]) for k, v in res["card16"][0].items()}
    out["bf16_rel_err"] = rel16
    if max(rel16.values()) > 0.05:
        raise AssertionError(f"card bf16 terms vs CPU fp32 beyond 5%: {rel16}")
    log("  fp32 terms: card " + " ".join(f"{k}={v:.6f}" for k, v in res["card32"][0].items())
        + "; CPU " + " ".join(f"{k}={v:.6f}" for k, v in cpu_t.items()))
    log("  fp32 grads, max|card-CPU| / max|CPU|: " + ", ".join(
        f"{k} {out[f'grad_rel_err {k}']:.3g}" for k in watch))
    log("  bf16 card terms vs CPU fp32, relative: " + ", ".join(
        f"{k} {v:.3g}" for k, v in rel16.items()))
    return out


def main():
    log("== 1. device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from gdn_tpu_torch import kernels as port_kernels
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
    port_kernels.load_all()
    log(f"  group_norm_elu and fused_loss built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")

    cfg = kitti_config(**{"model.use_pallas_gn": True})
    gn = gnk.group_norm_elu
    log("== 3. kernels vs plain (B=8, KITTI serving shapes)")
    rows = phase_kernels(cfg, gn)
    log(f"   and at the training batch (B={TRAIN_BATCH}, bf16, every site)")
    train_rows = phase_kernels_train(cfg, gn)

    log("== 4. slice: BatchedPredictor, full-width KITTI G-net, bf16")
    sd = init_params(cfg.model, torch.Generator().manual_seed(0))
    pred, launches, serving = phase_slice(cfg, sd, gn)

    log("== 5. server")
    phase_server(cfg, pred)

    log("== 6. fused loss kernels vs plain")
    loss_rows = phase_loss()

    log("== 7. GroupNorm+ELU gradients through the kernel")
    gn_grad_rows = phase_gn_grad()

    log(f"== 8. training: stage 1 then stage 2, full-width KITTI, bf16, "
        f"B={TRAIN_BATCH}")
    training, train_launches, _, s2, d_net = phase_train(cfg)

    log("== 9. one stage-2 step, card vs CPU, B=2")
    vs_cpu = phase_vs_cpu(cfg, s2, d_net)

    main_rows = [r for r in rows if r["dtype"] == str(torch.bfloat16)]
    per_fwd = {k: sum(r[k] * r["sites"] for r in main_rows)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    main_loss = loss_rows[0]
    path_launches = {"serving": {"group_norm_elu": launches}, **train_launches}

    def total(name):
        return sum(c.get(name, 0) for c in path_launches.values())

    kernels = [{
        "name": "group_norm_elu",
        "route": "cuda",
        "source": "gdn_tpu_torch/csrc/group_norm_elu.cu",
        "replaces": "gdn_tpu/kernels/groupnorm.py:133",
        "launches": total("group_norm_elu"),
        "max_abs_err": max(r["max_abs_err"] for r in main_rows + train_rows),
        **per_fwd,
        "bound_by": "bytes",
    }]
    for name, key, line in (("fused_loss_fwd", "fwd", 187), ("fused_loss_bwd", "bwd", 220)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "gdn_tpu_torch/csrc/fused_loss.cu",
            "replaces": f"gdn_tpu/kernels/fused_loss.py:{line}",
            "launches": total(name),
            "max_abs_err": main_loss[f"{key}_max_abs_err"],
            "ms": main_loss[f"{key}_ms"],
            "plain_ms": main_loss[f"{key}_plain_ms"],
            "bound_ms": main_loss[f"{key}_bound_ms"],
            "bound_by": "operations",
            "library_ms": None,  # no single PyTorch call computes this function
        })
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "chip_smoke.json"), "w") as f:
        json.dump({"device": smi, "torch": torch.__version__,
                   "per_shape": rows, "per_shape_train": train_rows,
                   "serving": serving, "loss": loss_rows,
                   "gn_grad": gn_grad_rows, "training": training,
                   "vs_cpu": vs_cpu, "launches": path_launches,
                   "kernels": kernels}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
