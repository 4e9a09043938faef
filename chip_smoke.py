#!/usr/bin/env python3
"""On-card smoke check of the PyTorch/CUDA port (gdn_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
repository around this file.  Phases, each printed on its own lines:

  1. device   the card's name and power limit (nvidia-smi);
  2. build    the three kernel libraries from gdn_tpu_torch/csrc, one
              nvcc each, started together (conv_gn_elu holds the whole
              fused conv family, the upsample entry point included);
              then the count of HMMA (tensor-core) instructions in the
              SASS of every instantiation of the tensor-core kernels
              (conv3x3_stats_tc and conv3x3_stats_tc_up; cuobjdump),
              which must not be zero; and, from an nvcc -Xptxas -v run
              beside the build, the registers and spills of the
              one-launch kernels (gn_elu_coop, loss_forward,
              loss_backward), which must not spill;
  3. kernels  at every (B=8, C, H, W, groups) shape the KITTI serving
              forward gives the GroupNorm+ELU kernel, in bf16 and fp32:
              kernel vs its plain PyTorch version on the same tensors,
              its (B, 2, G) statistics vs the plain fp32 ones, the plan
              it took (grid, slabs, held or streamed), with the
              kernel's (split by kernel name), the plain version's and
              the library yardstick's (F.group_norm + F.elu) times, the
              bound and the share of it reached; then at every training
              shape (B=32, bf16) and at the ragged set GN_RAGGED, the
              same checks;
  4. slice    the full-width KITTI G-net (random weights from seed 0,
              batch 8, bf16) serves 20 uint8 images through
              BatchedPredictor; the kernel must launch 21 times a batch;
              depth is checked against the same weights run on the CPU;
  5. server   DepthServer answers 3 concurrent POSTs (npy, png16,
              color) and /stats;
  6. loss     the fused loss forward and backward kernels vs their plain
              versions at B=32 128x416 (synthetic depth, ~5% holes, one
              all-masked image), at ragged 3x37x53, 2x11x16, 2x80x200
              (ragged tiles both ways) and 1x6x6, and with a 7-tap
              window; two forward calls on the same inputs must give
              the same bits; device times split by kernel name (the
              forward one kernel a call), bounds, the forward's plan
              and both kernels' registers, spills and shared memory;
  7. gn grad  GroupNorm+ELU gradients (x, scale, bias) through the
              kernel's autograd Function vs plain autograd, 3 serving
              shapes and the largest training one (32, 32, 128, 416);
  8. train    train_stage1 then train_stage2, 6 steps each, full-width
              KITTI, bf16, B=32, synthetic data on the card: finite
              losses, moved encoders, a bit-identical frozen decoder and
              D-net, the launches per step; ms/step and images/s; a
              profile of one stage-2 step;
  9. vs CPU   one stage-2 step at B=2, fp32, TF32 off: loss terms and
              gradients against the same step on the CPU; the card's
              bf16 loss terms against CPU fp32;
 10. conv     the fused conv3x3+GroupNorm+ELU kernels (stride 1 per
              image, stride 1, stride 2, two-input fusion) vs their plain
              versions at every site of a KITTI net, B=8 and B=32, bf16
              and fp32, and at ragged shapes: a, yn, inv; with device
              times of the kernel, the plain version and the unfused
              route (cuDNN conv [+ cat] + the GroupNorm+ELU kernel), and
              the bound.  Every entry point, whose bf16 taps run the
              tensor-core K loops: also fp32 inputs under bf16 taps at
              every site and ragged shape, and at every site the FMA K
              loop's time on the same inputs in the same call (the
              route of fp32 taps, launched through the wrapper's route
              argument, not counted);
 11. conv grad  gradients through each fused entry point's autograd
              Function vs autograd of its plain version, a shallow and a
              deep site each;
 12. fused slice  serving with use_pallas_convgn_bt/_s2 and
              use_pallas_fusion_bt on (6 GN+ELU, 5 + 5 + 5 fused launches
              a batch), then with use_pallas_convgn alone (16 GN+ELU, 5
              fused), each checked against the CPU;
 13. fused train  phase 8 with those flags on, 21 steps a stage, with
              the launches per step asserted exactly;
 14. fused vs CPU  phase 9 with those flags on;
 15. upsample, fusion block  the two entry points behind
              use_pallas_fusion (bilinear 2x + conv3x3 + GroupNorm + ELU;
              two-input conv3x3 + GroupNorm + ELU per image, both fp32
              out) vs their plain versions at their five sites of a KITTI
              net each, B=8 and B=32, bf16 and fp32, and at ragged shapes
              (H = 1, W = 1, odd W, 2W not a multiple of 8, Cin 5 and 48,
              Cout 6 and 40, Cx 12), with the times and bounds of phase
              10 (the unfused routes: the composed transposed conv, or cat
              + cuDNN conv, + the GroupNorm+ELU kernel; for the upsample
              also resize_bilinear + cuDNN conv, the uncomposed route),
              also with fp32 inputs under bf16 taps and beside the FMA K
              loop, as phase 10;
 16. their gradients  through each autograd Function vs autograd of the
              fp32 reference, a shallow and a deep site each;
 17. fusion slice  serving with use_pallas_fusion on (11 GN+ELU, 5
              upsample, 5 fusion-block launches a batch), then one pass
              with every fused flag on (1 GN+ELU, 5 s2, 5 bt, 5 fusion_bt,
              5 upsample, no fusion-block), each checked against the CPU;
 18. fusion train  phase 8 with use_pallas_fusion on, 6 steps a stage,
              launches per step asserted exactly;
 19. fusion vs CPU  phase 9 with use_pallas_fusion on.

Any failure ends the run with a nonzero exit.  The last lines are the
kernels' JSON line, the nvidia-smi line, and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Per-shape numbers also go to smoke_out/chip_smoke.json, the profiles to
smoke_out/{serving,training}{,_fused,_fusion}_profile.txt.
"""

import io
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import types
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "smoke_out")  # gitignored
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS = 67e12  # H100 SXM, outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores
L2_BYTES = 50 * 2**20
GN_FLOPS_PER_ELEM = 8  # sum, square-sum, center, scale, shift, ELU
TOL = {torch.bfloat16: (0.05, 0.05), torch.float32: (1e-4, 1e-5)}  # rtol, atol
BATCH = 8
TRAIN_BATCH = 32  # DataConfig.batch_size
TRAIN_STEPS = 6  # unfused configuration: the host clock times steps 2-6
FUSED_TRAIN_STEPS = 21  # fused configuration: steps 2-21
FUSED = {"model.use_pallas_convgn_bt": True, "model.use_pallas_convgn_s2": True,
         "model.use_pallas_fusion_bt": True}
FUSED_V1 = {"model.use_pallas_convgn": True}
FUSION = {"model.use_pallas_fusion": True}
COUNTERS = ("group_norm_elu", "fused_loss_fwd", "fused_loss_bwd", "conv_gn_elu",
            "conv_gn_elu_bt", "conv_gn_elu_s2", "fusion_bt", "fusion_block", "upsample")
FP32_OUT = ("conv_gn_elu", "fusion_block", "upsample")  # store fp32 a, no residuals
FMA_TIMING = types.SimpleNamespace(launches=0)  # counter of the FMA comparison launches
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


class ProfilerShort(RuntimeError):
    """torch.profiler recorded fewer kernel calls than were launched."""


EVENT_TIMED = []  # what device_ms had to time with CUDA events instead


def profiled(run, cpu=False, tries=4, min_calls=1):
    """(profiler, {kernel: (us, calls)}, wall s) of ``run()`` under
    torch.profiler.  CUPTI has on the H100 handed back, now and then, a
    session with no device rows at all, or with most of them missing,
    sometimes several sessions in a row; a session with fewer than
    ``min_calls`` kernel calls is run again after a pause, up to
    ``tries`` in all, and ProfilerShort is raised if every one came back
    short."""
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
        calls = sum(n for _, n in kernels.values())
        if calls >= min_calls:
            return prof, kernels, wall
        log(f"  (profiler session {attempt} of {tries} recorded {calls} kernel "
            f"calls, fewer than the {min_calls} launched)")
        time.sleep(0.5 * attempt)
    raise ProfilerShort(f"torch.profiler came back short in {tries} sessions")


def device_ms(fns, iters=20, what="", split=None):
    """Mean device ms of one call, from the profiler: the sum of the
    card's kernel times over a loop, whatever the host's pace.  Where
    the profiler keeps coming back short, the call is timed with CUDA
    events around the loop instead (an upper bound: it includes the gaps
    between launches), and ``what`` is noted in EVENT_TIMED.  A dict
    given as ``split`` receives {kernel name: device ms of one call}
    and, under "launches", the kernels one call launches."""
    for f in fns[:3]:
        f()
    n = max(iters, len(fns))

    def loop():
        for i in range(n):
            fns[i % len(fns)]()

    try:
        # every call launches a kernel; CUPTI on the H100 has recorded one
        # kernel fewer than launched in a loop of one-kernel calls, session
        # after session, so one short is taken and each kernel is averaged
        # over its own recorded launches
        _, kernels, _ = profiled(loop, min_calls=n - 1)
    except ProfilerShort:
        EVENT_TIMED.append(what)
        log(f"  (timing {what or 'this call'} with CUDA events instead)")
        return cuda_ms(fns, iters)
    # a kernel launched L times a call: its time over its recorded launches,
    # times L (= its launches over n, rounded)
    per_call = {k: us / 1e3 / calls * max(1, round(calls / n))
                for k, (us, calls) in kernels.items()}
    if split is not None:
        split.update({k[:80]: ms for k, ms in per_call.items()})
        split["launches"] = sum(max(1, round(c / n)) for _, c in kernels.values())
    return sum(per_call.values())


def split_text(split):
    """One line of device_ms's split: each kernel's us, then launches."""
    return "; ".join(f"{name} {ms * 1e3:.2f} us" if name != "launches"
                     else f"{ms:g} launches" for name, ms in (split or {}).items())


def sass_hmma():
    """{tensor-core kernel instantiation (conv3x3_stats_tc and
    conv3x3_stats_tc_up): HMMA instructions in its SASS} of the built
    conv_gn_elu library, from ``cuobjdump -sass``."""
    from gdn_tpu_torch.kernels import build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", build.target("conv_gn_elu")],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            if "conv3x3_stats_tc" in fn:
                counts[fn] = 0
        elif fn in counts and "HMMA" in line:
            counts[fn] += 1
    return counts


def start_ptxas(names):
    """One ``nvcc -cubin -Xptxas -v`` of each csrc/<name>.cu, started now
    (beside the build, which takes the same flags without -v)."""
    from gdn_tpu_torch.kernels import build

    os.makedirs(OUT, exist_ok=True)
    jobs = []
    for name in names:
        cmd = [build._nvcc(), *[f for f in build.NVCC_FLAGS if f not in (
            "-shared", "-Xcompiler", "-fPIC")], "-cubin", "-Xptxas", "-v", "-o",
            os.path.join(OUT, f"{name}.cubin"), os.path.join(build.CSRC, f"{name}.cu")]
        jobs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True))
    return jobs


def finish_ptxas(jobs, kernels):
    """{entry function naming one of ``kernels``: registers, spill stores,
    stack bytes} from the ptxas reports of start_ptxas."""
    out, fn = {}, None
    for job in jobs:
        text, _ = job.communicate(timeout=600)
        if job.returncode != 0:
            raise RuntimeError(f"nvcc -Xptxas -v failed:\n{text}")
        for line in text.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
                if any(k in fn for k in kernels):
                    out[fn] = {}
            elif fn in out and "spill stores" in line:
                nums = [int(t) for t in line.replace(",", " ").split() if t.isdigit()]
                out[fn].update(stack=nums[0], spill_stores=nums[1], spill_loads=nums[2])
            elif fn in out and "Used" in line and "registers" in line:
                out[fn]["registers"] = int(line.split("Used")[1].split()[0])
    if not out:
        raise AssertionError(f"ptxas reported none of {kernels}")
    return out


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


def gn_work(shape, item):
    """(flops, bytes) of one GroupNorm+ELU call on x of ``shape`` (B, C,
    H, W) with ``item`` bytes an element: GN_FLOPS_PER_ELEM a element;
    x read once, the output written once (x's dtype), the fp32 scale and
    bias read once."""
    b, c, h, w = shape
    numel = b * c * h * w
    return GN_FLOPS_PER_ELEM * numel, 2 * numel * item + 2 * c * 4


def loss_work(b, h, w):
    """{"fwd" | "bwd": (flops, bytes)} of one fused loss call on (b, h, w)
    fp32 maps, by the per-pixel counts above."""
    px = b * h * w
    return {"fwd": (LOSS_FWD_FLOPS_PX * px, LOSS_FWD_BYTES_PX * px),
            "bwd": (LOSS_BWD_FLOPS_PX * px, LOSS_BWD_BYTES_PX * px)}


def bound_ms(flops, nbytes):
    """The least time of fp32 work on the card: bytes at the memory rate
    or operations at the fp32 peak, whichever is longer."""
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)


# GroupNorm+ELU shapes beyond the net's sites: (B, C, H, W, groups, dtype,
# pointer offset in elements).  C 16 and 1024, odd H*W, H*W = 1, blocks of
# 252 and 255 threads (C / vec = 12 and 3), C % 8 != 0 and a pointer off 16
# bytes (the scalar route; 1024 threads a block at C = 1024 in fp32), and
# one tensor larger than the resident grid holds at B=8 (the streamed route
# in serving shapes).
GN_RAGGED = [
    (3, 16, 7, 9, 4, torch.bfloat16, 0),
    (2, 1024, 3, 5, 32, torch.bfloat16, 0),
    (2, 1024, 3, 5, 8, torch.float32, 0),
    (4, 64, 1, 1, 8, torch.bfloat16, 0),
    (3, 48, 13, 11, 8, torch.float32, 0),
    (2, 24, 11, 13, 8, torch.bfloat16, 0),
    (2, 12, 11, 13, 4, torch.bfloat16, 0),
    (2, 32, 9, 7, 8, torch.bfloat16, 1),
    (1, 1024, 2, 3, 8, torch.float32, 1),
    (BATCH, 32, 256, 416, 8, torch.bfloat16, 0),
]


def _gn_input(shape, dtype, gen, offset=0):
    """Channels_last x (B, C, H, W), its data ``offset`` elements into its
    storage (off 16 bytes where offset is odd)."""
    b, c, h, w = shape
    flat = torch.randn(offset + b * c * h * w, device="cuda", generator=gen) * 2 + 1
    return flat.to(dtype)[offset:].view(b, h, w, c).permute(0, 3, 1, 2)


def gn_check(gn, x, scale, bias, g, what):
    """The kernel's output against group_norm_elu_plain (phase-3
    tolerance) and its fp32 (B, 2, G) mean and inverse std against the
    plain fp32 statistics (rtol 1e-5, atol 1e-6); (max |out err|, max
    |stats err|, plan)."""
    from gdn_tpu_torch.kernels import groupnorm as gnk
    from gdn_tpu_torch.ops.groupnorm import _chanreduce_stats, group_norm_elu_plain

    out = gn(x, scale, bias, g)
    _, stats = gnk._launch(x, scale, bias, g, 1e-6)
    torch.cuda.synchronize()
    err = check_close(out, group_norm_elu_plain(x, scale, bias, g), x.dtype, what)
    mean_c, inv_c = _chanreduce_stats(x, g, 1e-6)
    cg = x.shape[1] // g
    want = torch.stack([mean_c[:, ::cg], inv_c[:, ::cg]], dim=1)
    serr = check_tol(stats, want, 1e-5, 1e-6, f"{what} (B, 2, G) statistics")
    return err, serr, gnk.plan_for(x, g)


def plan_text(plan):
    return (f"plan: grid {plan.grid}, {plan.slabs_per_image} slabs an image of "
            f"{plan.rows} rows, {plan.slabs_per_block} a block, "
            f"{'held' if plan.held else 'streamed'}")


def phase_kernels(cfg, gn):
    from gdn_tpu_torch.ops.groupnorm import group_norm_elu_plain, pick_groups

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for c, h, w in sorted(set(gn_sites(cfg.model)), reverse=True):
        g = pick_groups(c, cfg.model.group_norm_groups)
        count = gn_sites(cfg.model).count((c, h, w))
        for dtype in (torch.bfloat16, torch.float32):
            shape = (BATCH, c, h, w)
            flops, nbytes = gn_work(shape, torch.finfo(dtype).bits // 8)
            copies = max(1, -(-2 * L2_BYTES // nbytes))
            xs = [_gn_input(shape, dtype, gen) for _ in range(copies)]
            scale = torch.rand(c, device="cuda", generator=gen) + 0.5
            bias = torch.randn(c, device="cuda", generator=gen)
            what = f"group_norm_elu {tuple(shape)} {dtype}"
            err, serr, plan = gn_check(gn, xs[0], scale, bias, g, what)
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
                "sites": count, "max_abs_err": err, "stats_max_abs_err": serr,
                "plan": plan._asdict(), "bytes": nbytes, "bound_ms": bound_ms(flops, nbytes),
            }
            for k, f in fns.items():
                # ms: device time (the card's own, from the profiler);
                # call_ms: CUDA events around a loop of calls, host-bound
                # where the wrapper's Python outlasts the kernels.
                split = {} if k == "" else None
                row[f"{k}ms"] = device_ms(f, what=what, split=split)
                if split:
                    row["split_ms"] = split
                row[f"{k}call_ms"] = cuda_ms(f)
            rows.append(row)
            log(f"  {what}: max|k-p| {err:.3g}, stats {serr:.3g}; {plan_text(plan)}")
            log(f"    device us: kernel {row['ms']*1e3:.1f} plain "
                f"{row['plain_ms']*1e3:.1f} library {row['library_ms']*1e3:.1f} bound "
                f"{row['bound_ms']*1e3:.1f} ({row['bound_ms'] / row['ms']:.0%} of it "
                f"reached); per call us: kernel {row['call_ms']*1e3:.1f} plain "
                f"{row['plain_call_ms']*1e3:.1f} library {row['library_call_ms']*1e3:.1f}"
                f"  x{count} sites")
            log(f"    kernel split: {split_text(row.get('split_ms'))}")
            del xs
    return rows


def phase_kernels_train(cfg, gn):
    """The kernel vs its plain version at every site the stage-1 D-net
    and stage-2 G-net give it in training (B=32, bf16; both nets have
    the same 21 sites), at the same tolerance, statistics included; with
    the kernel's device time and bound per site.  Then the ragged set
    GN_RAGGED, checked the same way."""
    from gdn_tpu_torch.ops.groupnorm import pick_groups

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(4)
    dtype = torch.bfloat16
    for c, h, w in sorted(set(gn_sites(cfg.model)), reverse=True):
        g = pick_groups(c, cfg.model.group_norm_groups)
        shape = (TRAIN_BATCH, c, h, w)
        x = _gn_input(shape, dtype, gen)
        scale = torch.rand(c, device="cuda", generator=gen) + 0.5
        bias = torch.randn(c, device="cuda", generator=gen)
        what = f"group_norm_elu {shape} {dtype}"
        err, serr, plan = gn_check(gn, x, scale, bias, g, what)
        row = {"B": TRAIN_BATCH, "C": c, "H": h, "W": w, "groups": g,
               "dtype": str(dtype), "max_abs_err": err, "stats_max_abs_err": serr,
               "plan": plan._asdict(), "split_ms": {},
               "bound_ms": bound_ms(*gn_work(shape, x.element_size()))}
        row["ms"] = device_ms([lambda: gn(x, scale, bias, g)], what=what,
                              split=row["split_ms"])
        rows.append(row)
        log(f"  {what}: max|k-p| {err:.3g}, stats {serr:.3g}; {plan_text(plan)}")
        log(f"    device us: kernel {row['ms']*1e3:.1f} bound {row['bound_ms']*1e3:.1f} "
            f"({row['bound_ms'] / row['ms']:.0%} of it reached); kernel split: "
            f"{split_text(row['split_ms'])}")
        del x
    log("   and the ragged set")
    for b, c, h, w, g, dtype, offset in GN_RAGGED:
        shape = (b, c, h, w)
        x = _gn_input(shape, dtype, gen, offset)
        scale = torch.rand(c, device="cuda", generator=gen) + 0.5
        bias = torch.randn(c, device="cuda", generator=gen)
        what = f"group_norm_elu {shape} {dtype} offset {offset}"
        err, serr, plan = gn_check(gn, x, scale, bias, g, what)
        rows.append({"B": b, "C": c, "H": h, "W": w, "groups": g, "dtype": str(dtype),
                     "offset": offset, "max_abs_err": err, "stats_max_abs_err": serr,
                     "plan": plan._asdict(), "ragged": True})
        log(f"  {what}: max|k-p| {err:.3g}, stats {serr:.3g}; {plan_text(plan)}")
        del x
    return rows


def _counted():
    """{name in the kernels line: the wrapper that carries its count}."""
    from gdn_tpu_torch.kernels import conv_gn_elu as ck
    from gdn_tpu_torch.kernels import fused_loss as fl
    from gdn_tpu_torch.kernels import fusion_block as fb
    from gdn_tpu_torch.kernels import fusion_bt as fk
    from gdn_tpu_torch.kernels import groupnorm as gnk
    from gdn_tpu_torch.kernels import upsample as uk

    fns = (gnk.group_norm_elu, fl.fused_loss_fwd, fl.fused_loss_bwd,
           ck.fused_conv_gn_elu, ck.fused_conv_gn_elu_bt, ck.fused_conv_gn_elu_s2,
           fk.fused_fusion_bt, fb.fused_fusion_block, uk.fused_upsample_conv)
    return dict(zip(COUNTERS, fns))


def reset_counts():
    for fn in _counted().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in _counted().items()}


def expect_counts(what, got, **want):
    want = {name: want.get(name, 0) for name in COUNTERS}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def conv_sites(m):
    """The 20 fused sites of one net, by entry point: stride-2 and
    refine convs of each DownBlock and the UpBlock up-convs as (Cin,
    Cout, H, W) of the input, fusion sites as (Cx, Cl, Cout, H, W)."""
    h, w = m.image_size
    cin, sizes = m.enc_channels[0], [m.image_size]
    s2, bt, fusion, up = [], [], [], []
    for ch in m.enc_channels:
        s2.append((cin, ch, h, w))
        h, w = -(-h // 2), -(-w // 2)
        bt.append((ch, ch, h, w))
        sizes.append((h, w))
        cin = ch
    skips = [m.enc_channels[0], *m.enc_channels[:-1]]
    n = len(skips)
    for i, ch in enumerate(m.dec_channels):
        fusion.append((ch, skips[n - 1 - i], ch, *sizes[n - 1 - i]))
        up.append((cin, ch, *sizes[n - i]))
        cin = ch
    return {"conv_gn_elu": bt, "conv_gn_elu_bt": bt, "conv_gn_elu_s2": s2,
            "fusion_bt": fusion, "fusion_block": fusion, "upsample": up}


def phase_slice(cfg, sd, per_batch, tag="serving", n_images=20, timed=True):
    """Serve ``n_images`` through BatchedPredictor under ``cfg``; the
    kernels must launch exactly ``per_batch`` times a batch; depth is
    held against the same weights and flags on the CPU."""
    from gdn_tpu_torch.config import _with
    from gdn_tpu_torch.serving import BatchedPredictor

    h, w = cfg.model.image_size
    images = np.random.default_rng(0).integers(0, 256, (n_images, h, w, 3), np.uint8)
    pred = BatchedPredictor(cfg, sd, batch_size=BATCH)
    pred.predict(images[:BATCH])  # warm-up: cuDNN algorithm search
    torch.cuda.synchronize()
    reset_counts()
    depth = pred.predict(images)
    counts = read_counts()
    batches = -(-len(images) // BATCH)
    log(f"  {n_images} images in {batches} batches: launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    if depth.shape != (n_images, h, w):
        raise AssertionError(f"depth shape {depth.shape}")
    if not (np.isfinite(depth).all() and (depth > 0).all()
            and (depth <= cfg.model.max_depth).all()):
        raise AssertionError("depth not finite in (0, max_depth]")
    expect_counts(tag, counts, **{k: v * batches for k, v in per_batch.items()})

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
    info = {"launches_per_batch": {k: v // batches for k, v in counts.items() if v},
            "card_fp32_vs_cpu_max_m": float(np.abs(gpu32 - cpu).max()),
            "card_bf16_vs_cpu_max_m": float(d.max()),
            "card_bf16_vs_cpu_mean_m": float(d.mean())}
    if not timed:
        return pred, counts, info

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
    info.update(ms_per_batch=ms_batch, images_per_s=len(many) / t,
                profile=profile_serving(pred, many, tag))
    return pred, counts, info


def profile_serving(pred, images, tag):
    """Where one serving call's time goes: the card's busy share of the
    wall time, and its kernels by device time (table in OUT)."""
    try:
        prof, kernels, wall = profiled(lambda: pred.predict(images), cpu=True)
    except ProfilerShort as e:
        log(f"  profile of {tag}: not measured ({e})")
        return None
    busy_ms = sum(us for us, _ in kernels.values()) / 1e3

    def named(*parts):
        return sum(us for k, (us, _) in kernels.items()
                   if any(part in k for part in parts)) / 1e3

    gn_ms = named("gn_elu_coop")
    conv_ms = named("conv3x3_stats", "gn_elu_apply")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, f"{tag}_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=40))
    out = {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
           "idle_share": 1 - busy_ms / (wall * 1e3), "gn_elu_device_ms": gn_ms,
           "fused_conv_device_ms": conv_ms,
           "kernel_launches": sum(n for _, n in kernels.values()),
           "top_kernels_us": [(k[:90], us, n) for k, (us, n) in top]}
    log(f"  profile of {len(images)} images: wall {out['wall_ms']:.1f} ms, "
        f"device busy {busy_ms:.2f} ms (idle {out['idle_share']:.1%}), "
        f"GN+ELU kernels {gn_ms:.3f} ms, fused conv kernels {conv_ms:.3f} ms, "
        f"{out['kernel_launches']} launches")
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


LOSS_SHAPES = [(TRAIN_BATCH, 128, 416, 11), (3, 37, 53, 11), (2, 11, 16, 11),
               (2, 80, 200, 11), (1, 6, 6, 11), (2, 80, 200, 7)]  # (B, H, W, window)


def phase_loss():
    """Both loss kernels vs their plain versions at LOSS_SHAPES (the
    training shape; ragged tiles in both directions; the least side; a
    7-tap window).  Sums: rtol 1e-5 (the JAX suite's value bound) on the
    counts' and sums' scale, atol 1e-6, and two forward calls on the same
    inputs bit-identical.  dpred: rtol 2e-4 (the JAX suite's gradient
    bound) plus an absolute floor of 1e-5 of the largest |dpred| (the
    per-image cotangents are ~1/N, and elements near 0 see the adjoint's
    cancellations).  At the training shape the forward's device time
    must come from one kernel a call."""
    from gdn_tpu_torch.kernels import fused_loss as fl

    gen = torch.Generator(device="cuda").manual_seed(1)
    ct = torch.tensor([1.0, 1.0, 0.5], device="cuda")  # w_recon, w_grad, w_ssim
    rows = []
    for b, h, w, window in LOSS_SHAPES:
        main = b == TRAIN_BATCH
        what = f"{b}x{h}x{w} window {window}"
        ins = _loss_inputs(b, h, w, 3 if main else 1, gen)
        pred, gt, mask = ins[0]
        raw = fl.fused_loss_fwd(pred, gt, mask, 80.0, window)
        again = fl.fused_loss_fwd(pred, gt, mask, 80.0, window)
        ref = fl.loss_sums_plain(pred, gt, mask, 80.0, window)
        fwd_err = check_tol(raw, ref, 1e-5, 1e-6, f"fused_loss_fwd {what}")
        if not torch.equal(raw, again):
            raise AssertionError(f"fused_loss_fwd {what}: two calls differ by "
                                 f"{(raw - again).abs().max().item():.3g}")
        cts = fl._cotangents(ref, ct)
        d = fl.fused_loss_bwd(pred, gt, mask, cts, 80.0, window)
        dref = fl.fused_loss_bwd_plain(pred, gt, mask, cts, 80.0, window)
        torch.cuda.synchronize()
        floor = 1e-5 * dref.abs().max().item()
        bwd_err = check_tol(d, dref, 2e-4, floor, f"fused_loss_bwd {what}")
        plan = fl.plan_for(pred, window)
        row = {"B": b, "H": h, "W": w, "window": window, "fwd_max_abs_err": fwd_err,
               "fwd_max_rel_err": ((raw - ref).abs() / ref.abs().clamp(min=1e-30)).max().item(),
               "fwd_plan": plan._asdict(),
               "bwd_max_abs_err": bwd_err, "bwd_max_abs_ref": dref.abs().max().item()}
        log(f"  {what}: sums max|k-p| {fwd_err:.3g} (rel "
            f"{row['fwd_max_rel_err']:.3g}), a second call bit-identical; dpred max|k-p| "
            f"{bwd_err:.3g} of max|p| {row['bwd_max_abs_ref']:.3g}; forward plan "
            f"{plan.tiles_y}x{plan.tiles_x} tiles an image, {plan.grid} blocks, "
            f"<= {plan.tiles_per_block} tiles a block")
        if main:
            work = loss_work(b, h, w)
            row["fwd_bound_ms"] = bound_ms(*work["fwd"])
            row["bwd_bound_ms"] = bound_ms(*work["bwd"])
            row["fwd_resources"] = fres = fl.forward_resources()
            row["bwd_resources"] = res = fl.backward_resources()
            log(f"  forward kernel: {fres['registers']} registers and "
                f"{fres['local_bytes']} local (spill) bytes a thread, "
                f"{fres['static_smem'] + fres['dynamic_smem']} bytes of shared memory and "
                f"{fres['threads']} threads a block, {fl.FWD_TILE[0]}x{fl.FWD_TILE[1]} "
                f"tiles, {fres['blocks_per_sm']} blocks an SM")
            log(f"  backward kernel: {res['registers']} registers and "
                f"{res['local_bytes']} local (spill) bytes a thread, "
                f"{res['static_smem'] + res['dynamic_smem']} bytes of shared memory and "
                f"{res['threads']} threads a block")
            for name, r in (("forward", fres), ("backward", res)):
                if r["local_bytes"]:
                    raise AssertionError(f"the loss {name} kernel spills: {r}")
            fns = {
                "fwd_ms": [lambda i=i: fl.fused_loss_fwd(*i, 80.0) for i in ins],
                "fwd_plain_ms": [lambda i=i: fl.loss_sums_plain(*i, 80.0) for i in ins],
                "bwd_ms": [lambda i=i: fl.fused_loss_bwd(*i, cts, 80.0) for i in ins],
                "bwd_plain_ms": [lambda i=i: fl.fused_loss_bwd_plain(*i, cts, 80.0)
                                 for i in ins],
            }
            for k, f in fns.items():
                if k in ("fwd_ms", "bwd_ms"):
                    row[k.replace("ms", "split_ms")] = split = {}
                    row[k] = device_ms(f, what=k, split=split)
                    log(f"  {k[:3]} kernels, one call: {split_text(split)}")
                else:
                    row[k] = device_ms(f)
            fsplit = row["fwd_split_ms"]
            for _ in range(2):  # events time no split: profile the forward again
                if fsplit:
                    break
                device_ms(fns["fwd_ms"], what="fwd split", split=fsplit)
                log(f"  fwd kernels, one call: {split_text(fsplit)}")
            if not fsplit or fsplit["launches"] != 1 or len(fsplit) != 2:
                raise AssertionError(f"the loss forward is not one kernel a call: {fsplit}")
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


def phase_train(cfg, steps, per_net, tag="train"):
    """train_stage1 then train_stage2, ``steps`` each; ``per_net`` is
    the model kernels' launches in one net's forward (stage 2 runs two
    nets a step: the G-net under grad and the frozen D-net)."""
    from gdn_tpu_torch.checkpoint import init_params, load_pth
    from gdn_tpu_torch.config import _with
    from gdn_tpu_torch.data.synthetic import SyntheticDataset
    from gdn_tpu_torch.models import DtoDNet
    from gdn_tpu_torch.train.loop import train_stage1, train_stage2
    from gdn_tpu_torch.utils.logging import MetricLogger

    ckpt = os.path.join(OUT, tag)
    cfg = _with(cfg, **{"train.steps_per_epoch": steps,
                        "train.log_every": steps, "train.ckpt_dir": ckpt,
                        "data.batch_size": TRAIN_BATCH})
    h, w = cfg.model.image_size
    data = iter(SyntheticDataset(TRAIN_BATCH, h, w, cfg.model.max_depth, seed=0,
                                 device="cuda"))
    out, launches = {}, {}
    for stage in ("stage1", "stage2"):
        jsonl = os.path.join(OUT, f"{tag}_{stage}.jsonl")
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
        nets = 1 if stage == "stage1" else 2
        expect_counts(f"{tag} {stage}", counts, fused_loss_fwd=steps, fused_loss_bwd=steps,
                      **{k: v * nets * steps for k, v in per_net.items()})
        terms = {k: v for k, v in rec.items() if k not in ("t", "step", "imgs_per_sec")}
        if not all(np.isfinite(v) for v in terms.values()):
            raise AssertionError(f"{stage} loss not finite: {rec}")
        ips = rec["imgs_per_sec"]
        out[stage] = {"images_per_s": ips, "ms_per_step": 1e3 * TRAIN_BATCH / ips,
                      "last_terms": terms, "launches": counts}
        log(f"  {stage}: {steps} steps, launches "
            f"{ {k: v for k, v in counts.items() if v} }; "
            f"{out[stage]['ms_per_step']:.1f} ms/step, {ips:.1f} images/s "
            f"(host clock, steps 2-{steps}); last terms "
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
    out["profile"] = profile_train_step(cfg, s2, d_net, next(data), tag)
    return out, launches, s1, s2, d_net


def profile_train_step(cfg, state, d_net, batch, tag):
    """One stage-2 step under torch.profiler: the card's busy share of
    the wall time and its kernels by device time (table in OUT)."""
    from gdn_tpu_torch.train.steps import make_stage2_step

    step = make_stage2_step(cfg)
    step(state, d_net, batch)
    try:
        prof, kernels, wall = profiled(lambda: step(state, d_net, batch), cpu=True)
    except ProfilerShort as e:
        log(f"  profile of {tag}: not measured ({e})")
        return None
    busy_ms = sum(us for us, _ in kernels.values()) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    with open(os.path.join(OUT, f"{tag}_profile.txt"), "w") as f:
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


RAGGED = {  # (B, channels..., H, W): odd sizes at stride 2, ragged channels
    "conv_gn_elu": [(3, 24, 40, 9, 11)],
    "conv_gn_elu_bt": [(3, 24, 40, 9, 11), (2, 5, 6, 7, 5)],
    "conv_gn_elu_s2": [(2, 64, 128, 57, 76), (3, 16, 32, 29, 37), (2, 5, 6, 7, 5)],
    # Cl 20 and Cx 12 (register path), Cx 16 + Cl 32 -> 16 (the BN = 16 tile)
    "fusion_bt": [(2, 48, 20, 12, 9, 7), (3, 16, 32, 16, 29, 37), (2, 12, 16, 24, 9, 7)],
    "fusion_block": [(2, 48, 20, 12, 9, 7), (3, 16, 32, 16, 29, 37), (2, 5, 3, 6, 1, 13),
                     (2, 12, 16, 24, 9, 7)],
    # H = 1; odd W with 2W % 8 != 0, Cin 48, Cout 40; Cin 5, Cout 6; W = 1
    "upsample": [(2, 32, 16, 1, 7), (3, 48, 40, 4, 13), (2, 5, 6, 3, 5), (2, 16, 8, 5, 1)],
}


def _conv_case(name, shape, dtype, copies, gen, tap=None):
    """Inputs of one fused site and its three routes on them: the kernel
    (with residuals; ``serve`` is the no-grad entry point that stores a
    alone), the plain version, and the unfused route the port offers
    (cuDNN conv [+ cat] + the GroupNorm+ELU kernel; for the upsample the
    composed transposed conv in front of it, and in
    ``library_uncomposed`` resize_bilinear + cuDNN conv, the
    ``resize_conv_composed=False`` route); and ``fma(residuals)``, the
    same launch through the FMA K loop.  ``tap`` is the tap dtype, x's by
    default."""
    from gdn_tpu_torch.kernels import conv_gn_elu as ck
    from gdn_tpu_torch.kernels import fusion_block as fb
    from gdn_tpu_torch.kernels import fusion_bt as fk
    from gdn_tpu_torch.kernels import upsample as uk
    from gdn_tpu_torch.kernels.groupnorm import group_norm_elu
    from gdn_tpu_torch.ops.conv import conv_same
    from gdn_tpu_torch.ops.groupnorm import pick_groups
    from gdn_tpu_torch.ops.resize import composed_resize_conv2x, resize_bilinear

    cl = torch.channels_last
    tap = tap or ("bfloat16" if dtype == torch.bfloat16 else "float32")
    library_uncomposed = None
    b, *chans, h, w = shape
    cout, cins = chans[-1], chans[:-1]
    stride = 2 if name == "conv_gn_elu_s2" else 1
    g = pick_groups(cout, 8)
    out_dtype = torch.float32 if name in FP32_OUT else dtype

    def act(c):
        return [torch.randn((b, c, h, w), device="cuda", generator=gen).to(dtype)
                .contiguous(memory_format=cl) for _ in range(copies)]

    xs = [act(c) for c in cins]  # one list of copies per input
    k = torch.randn((cout, sum(cins), 3, 3), device="cuda", generator=gen) * (
        2.0 / (9 * sum(cins))) ** 0.5
    ks = torch.split(k, cins, dim=1)
    scale = torch.rand(cout, device="cuda", generator=gen) + 0.5
    bias = torch.randn(cout, device="cuda", generator=gen) * 0.1
    kd = k.to(dtype)
    if name in ("fusion_bt", "fusion_block"):
        def library(x, lat):
            return group_norm_elu(conv_same(torch.cat([x, lat], 1), kd), scale, bias, g)

        if name == "fusion_bt":
            def kernel(x, lat):
                return fk._fusion_bt_all(x, lat, *ks, scale, bias, g, 1e-6, tap)

            def serve(x, lat):
                return fk.fused_fusion_bt(x, lat, *ks, scale, bias, g, 1e-6, tap)

            def plain(x, lat):
                return fk.fusion_bt_plain(x, lat, *ks, scale, bias, g, 1e-6, tap)
        else:
            serve = None

            def kernel(x, lat):
                return (fb.fused_fusion_block(x, lat, *ks, scale, bias, g, 1e-6, tap),
                        None, None)

            def plain(x, lat):
                return (fb.fusion_block_plain(x, lat, *ks, scale, bias, g, 1e-6, tap),
                        None, None)
    elif name == "upsample":
        serve = None
        kcl = kd.contiguous(memory_format=cl)

        def library_uncomposed(x):  # resize_conv_composed=False
            y = conv_same(resize_bilinear(x, (2 * h, 2 * w), precise=False), kd)
            return group_norm_elu(y, scale, bias, g)

        def kernel(x):
            return (uk.fused_upsample_conv(x, k, scale, bias, g, 1e-6, tap), None, None)

        def plain(x):
            return (uk.upsample_conv_plain(x, k, scale, bias, g, 1e-6, tap), None, None)

        def library(x):
            y = composed_resize_conv2x(x, kcl).contiguous(memory_format=cl)
            return group_norm_elu(y, scale, bias, g)
    else:
        if name == "conv_gn_elu":
            def kernel(x):
                return (ck.fused_conv_gn_elu(x, k, scale, bias, g, 1e-6, tap), None, None)
            serve = None
        else:
            entry, full = {
                "conv_gn_elu_bt": (ck.fused_conv_gn_elu_bt, ck._conv_gn_elu_bt_all),
                "conv_gn_elu_s2": (ck.fused_conv_gn_elu_s2, ck._conv_gn_elu_s2_all),
            }[name]

            def kernel(x):
                return full(x, k, scale, bias, g, 1e-6, tap)

            def serve(x):
                return entry(x, k, scale, bias, g, 1e-6, tap)

        def plain(x):
            return ck.conv_gn_elu_plain(x, k, scale, bias, g, 1e-6, stride, tap, out_dtype)

        def library(x):
            return group_norm_elu(conv_same(x, kd, stride), scale, bias, g)
    wx, wl = ks if len(cins) == 2 else (k, None)

    def fma(residuals):
        return lambda x, lat=None: ck._launch(FMA_TIMING, x, lat, wx, wl, scale, bias, g,
                                              1e-6, stride, tap, out_dtype, residuals,
                                              upsample=name == "upsample", route="fma")
    ins = list(zip(*xs))  # one tuple of inputs per copy
    return dict(kernel=kernel, serve=serve, plain=plain, library=library, ins=ins, fma=fma,
                library_uncomposed=library_uncomposed)


def conv_work(name, shape, item, residuals):
    """(flops, bytes) of one call of fused entry point ``name`` on input
    ``shape`` (B, channels..., H, W), as in ``conv_sites`` and RAGGED,
    ``item`` bytes an input element: 18 Cin Cout Ho Wo B flops; the
    inputs read once, the fp32 weights, scale and bias, and ``a`` (fp32
    for the fp32-out entry points, else x's dtype) written once, with
    ``residuals`` also ``yn`` (as ``a``) and the fp32 ``inv``."""
    b, *chans, h, w = shape
    cout, cin = chans[-1], sum(chans[:-1])
    stride = 2 if name == "conv_gn_elu_s2" else 1
    ho, wo = (2 * h, 2 * w) if name == "upsample" else (-(-h // stride), -(-w // stride))
    out_item = 4 if name in FP32_OUT else item
    out = b * cout * ho * wo * out_item
    in_bytes = b * cin * h * w * item + 9 * cin * cout * 4 + 2 * cout * 4
    out_bytes = out + (out + b * cout * 4 if residuals else 0)
    return 18 * cin * cout * ho * wo * b, in_bytes + out_bytes


def phase_conv_kernels(cfg, names):
    """The fused entry points ``names`` vs their plain versions, with times.

    Tolerance: fp32 rtol 1e-4 / atol 1e-5 (the JAX suite's for these
    kernels against their reference); bf16 0.05 + 0.05 |ref| on a and yn
    as phase 3 (one bf16 rounding of an O(1) value is up to 0.0156; the
    kernel and cuDNN sum the taps in other orders, so a value near a
    rounding boundary may land on either side), inv (fp32 in both) and
    the fp32 a of the per-image, fusion-block and upsample entry points
    (the same bf16 taps on both sides: the upsample's plain version blends
    in the kernel's order, and the kernel pins each rounding) at the fp32
    tolerance; so are a and yn with fp32 inputs under bf16 taps (both
    sides round the inputs, or the upsample's blend, to bf16 and sum
    exact products in fp32).  The bound is the larger of the flops at
    the card's peak for the tap dtype (dense bf16 tensor rate; fp32 FMA
    rate for fp32 taps) and the bytes (``conv_work``) at the memory
    rate.  With bf16 taps the FMA K loop runs on the same inputs in the
    same call (``fma_ms``), and for the upsample also the uncomposed
    route (``library_uncomposed_ms``)."""
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(5)
    sites = conv_sites(cfg.model)
    for name in names:
        cases = [((b, *site), True) for b in (BATCH, TRAIN_BATCH) for site in sites[name]]
        cases += [(shape, False) for shape in RAGGED[name]]
        # fp32 inputs under bf16 taps: rounded to bf16 as the kernel gathers them
        runs = [(torch.bfloat16, "bfloat16"), (torch.float32, "float32"),
                (torch.float32, "bfloat16")]
        for shape, site in cases:
            for dtype, tap in runs:
                b = shape[0]
                main = site and tap == ("bfloat16" if dtype == torch.bfloat16 else "float32")
                item = torch.finfo(dtype).bits // 8
                nbytes = conv_work(name, shape, item, True)[1]
                copies = min(4, max(1, -(-2 * L2_BYTES // nbytes))) if main else 1
                case = _conv_case(name, shape, dtype, copies, gen, tap)
                got = case["kernel"](*case["ins"][0])
                torch.cuda.synchronize()
                want = case["plain"](*case["ins"][0])
                what = f"{name} {shape} {dtype} taps {tap}"
                errs = {}
                for part, g_, w_ in zip(("a", "yn", "inv"), got, want):
                    if g_ is None:
                        continue
                    exact = part == "inv" or name in FP32_OUT  # fp32 in both
                    tol = TOL[torch.float32 if exact else dtype]
                    errs[part] = check_tol(g_, w_, *tol, f"{what} {part}")
                row = {"kernel": name, "shape": list(shape), "dtype": str(dtype),
                       "tap": tap, "main": main, "max_abs_err": errs}
                line = f"  {what}: max|k-p| " + " ".join(
                    f"{k} {v:.3g}" for k, v in errs.items())
                if main:
                    # B=32 is training: a, yn and inv stored; B=8 is
                    # serving: a alone (the per-image kernel never stores
                    # residuals).
                    train = b == TRAIN_BATCH and case["serve"] is not None
                    timed = case["kernel"] if train or case["serve"] is None else case["serve"]
                    flops, nbytes = conv_work(name, shape, item, train)
                    peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
                    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
                    routes = [("ms", timed), ("plain_ms", case["plain"]),
                              ("library_ms", case["library"])]
                    if case["library_uncomposed"] is not None:
                        routes.append(("library_uncomposed_ms", case["library_uncomposed"]))
                    row.update(
                        residuals=train, flops=flops, bytes=nbytes,
                        bound_ms=1e3 * max(t_ops, t_bytes),
                        bound_by="operations" if t_ops >= t_bytes else "bytes",
                        **{key: device_ms([lambda i=i: fn(*i) for i in case["ins"]], 10,
                                          f"{what} {key}") for key, fn in routes})
                    row["tflops"] = flops / row["ms"] / 1e9
                    line += (f"  device us: kernel {row['ms']*1e3:.1f} "
                             f"({row['tflops']:.1f} TFLOP/s) plain {row['plain_ms']*1e3:.1f}"
                             f" unfused {row['library_ms']*1e3:.1f} bound "
                             f"{row['bound_ms']*1e3:.2f} ({row['bound_by']})")
                    if "library_uncomposed_ms" in row:
                        line += f" uncomposed {row['library_uncomposed_ms']*1e3:.1f}"
                    if tap == "bfloat16":
                        fma = case["fma"](train)
                        row["fma_ms"] = device_ms([lambda i=i: fma(*i) for i in case["ins"]],
                                                  10, f"{what} fma_ms")
                        row["fma_tflops"] = flops / row["fma_ms"] / 1e9
                        line += (f"; FMA K loop {row['fma_ms']*1e3:.1f} "
                                 f"({row['fma_tflops']:.1f} TFLOP/s, same call)")
                rows.append(row)
                log(line)
                del case, got, want
    return rows


CONV_GRAD_CASES = {
    "conv_gn_elu": [(BATCH, 32, 32, 64, 208), (BATCH, 512, 512, 4, 13)],
    "conv_gn_elu_bt": [(TRAIN_BATCH, 32, 32, 64, 208), (TRAIN_BATCH, 512, 512, 4, 13)],
    "conv_gn_elu_s2": [(TRAIN_BATCH, 32, 32, 128, 416), (TRAIN_BATCH, 256, 512, 8, 26)],
    "fusion_bt": [(TRAIN_BATCH, 16, 32, 16, 128, 416), (TRAIN_BATCH, 256, 256, 256, 8, 26)],
}
FUSION_GRAD_CASES = {
    "fusion_block": CONV_GRAD_CASES["fusion_bt"],
    "upsample": [(TRAIN_BATCH, 32, 16, 64, 208), (TRAIN_BATCH, 512, 256, 4, 13)],
}


def phase_conv_grad(cases):
    """Gradients in every tensor input through each fused entry point's
    autograd Function vs autograd of its plain version (for the fp32-out
    entry points, whose backward is the VJP of the fp32 reference
    whatever the taps: of the plain version with fp32 taps), on the
    card, at a shallow and a deep site each.  fp32: rtol 1e-3 (the JAX suite's
    gradient bound for these kernels) with an absolute floor of 1e-5 of
    the gradient's largest magnitude (the weight gradients sum B*H*W
    terms in other orders; the suite's atol 1e-5 is for gradients of
    O(1)).  bf16: within 2% of the gradient's largest magnitude, as
    phase 7 (the analytic chain rounds to bf16 where the plain graph
    stays fp32)."""
    from gdn_tpu_torch.kernels import conv_gn_elu as ck
    from gdn_tpu_torch.kernels import fusion_block as fb
    from gdn_tpu_torch.kernels import fusion_bt as fk
    from gdn_tpu_torch.kernels import upsample as uk
    from gdn_tpu_torch.ops.groupnorm import pick_groups

    cl = torch.channels_last
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    for name, shapes in cases.items():
        for shape in shapes:
            for dtype in (torch.bfloat16, torch.float32):
                tap = "bfloat16" if dtype == torch.bfloat16 else "float32"
                ref_tap = "float32" if name in FP32_OUT else tap
                b, *chans, h, w = shape
                cout, cins = chans[-1], chans[:-1]
                g = pick_groups(cout, 8)
                stride = 2 if name == "conv_gn_elu_s2" else 1
                acts = [torch.randn((b, c, h, w), device="cuda", generator=gen).to(dtype)
                        .contiguous(memory_format=cl) for c in cins]
                ks = [torch.randn((cout, c, 3, 3), device="cuda", generator=gen)
                      * (2.0 / (9 * sum(cins))) ** 0.5 for c in cins]
                scale = torch.rand(cout, device="cuda", generator=gen) + 0.5
                bias = torch.randn(cout, device="cuda", generator=gen) * 0.1
                tensors = [*acts, *ks, scale, bias]
                if name == "fusion_bt":
                    fused = lambda *t: fk.fused_fusion_bt(*t, g, 1e-6, tap)
                    plain = lambda *t: fk.fusion_bt_plain(*t, g, 1e-6, tap)[0]
                elif name == "fusion_block":
                    fused = lambda *t: fb.fused_fusion_block(*t, g, 1e-6, tap)
                    plain = lambda *t: fb.fusion_block_plain(*t, g, 1e-6, ref_tap)
                elif name == "upsample":
                    fused = lambda *t: uk.fused_upsample_conv(*t, g, 1e-6, tap)
                    plain = lambda *t: uk.upsample_conv_plain(*t, g, 1e-6, ref_tap)
                else:
                    entry = {"conv_gn_elu": ck.fused_conv_gn_elu,
                             "conv_gn_elu_bt": ck.fused_conv_gn_elu_bt,
                             "conv_gn_elu_s2": ck.fused_conv_gn_elu_s2}[name]
                    out_dtype = torch.float32 if name == "conv_gn_elu" else None
                    fused = lambda *t: entry(*t, g, 1e-6, tap)
                    plain = lambda *t: ck.conv_gn_elu_plain(*t, g, 1e-6, stride, ref_tap,
                                                            out_dtype)[0]
                grads, da = [], None
                for fn in (fused, plain):
                    leaves = [t.clone().requires_grad_(True) for t in tensors]
                    out = fn(*leaves)
                    if out.grad_fn is None:
                        raise AssertionError(f"{name} output has no grad_fn")
                    if da is None:
                        da = torch.randn(out.shape, device="cuda", generator=gen).to(
                            out.dtype).contiguous(memory_format=cl)
                    grads.append(torch.autograd.grad(out, leaves, da))
                    del out, leaves
                torch.cuda.synchronize()
                what = f"{name} grad {shape} {dtype}"
                names = [f"d{n}" for n in (["x", "lat", "wx", "wl"] if len(cins) == 2
                                           else ["x", "w"])] + ["dscale", "dbias"]
                errs, refs = [], []
                for n, got, want in zip(names, *grads):
                    top = want.float().abs().max().item()
                    if dtype == torch.float32:
                        errs.append(check_tol(got, want, 1e-3, 1e-5 * top, f"{what} {n}"))
                    else:
                        errs.append(check_tol(got, want, 0.0, 0.02 * top, f"{what} {n}"))
                    refs.append(top)
                rows.append({"kernel": name, "shape": list(shape), "dtype": str(dtype),
                             "grads": names, "max_abs_err": errs, "max_abs_ref": refs})
                log(f"  {what}: max|k-p| / max|p| " + " ".join(
                    f"{n} {e / r:.2g}" for n, e, r in zip(names, errs, refs)))
                del grads, tensors, acts
    return rows


def _family_entry(name, line, rows, launches, hmma):
    """One fused conv entry point's object of the kernels line: its five
    sites of a net summed at the batch its main path runs in bf16 (B=8
    serving for the per-image kernel, B=32 training for the others; the
    B=8 sums are in chip_smoke.json), with the FMA K loop's time on the
    same inputs (``fma_ms``), the error with fp32 inputs under bf16 taps,
    the HMMA count of the tensor-core kernels' SASS and, for the
    upsample, the uncomposed library route beside the composed one."""
    batch = BATCH if name == "conv_gn_elu" else TRAIN_BATCH
    # (fusion_block and upsample run in serving at B=8 and in training
    # at B=32; their line takes the training batch like bt, s2, fusion_bt)
    mine = [r for r in rows if r["kernel"] == name and r["main"]]
    picked = [r for r in mine if r["shape"][0] == batch
              and r["dtype"] == str(torch.bfloat16)]
    bound = {by: sum(r["bound_ms"] for r in picked if r["bound_by"] == by)
             for by in ("operations", "bytes")}
    sums = ["ms", "plain_ms", "library_ms", "bound_ms", "fma_ms"]
    if name == "upsample":
        sums.append("library_uncomposed_ms")
    return {
        "name": name,
        "route": "cuda",
        "source": "gdn_tpu_torch/csrc/conv_gn_elu.cu",
        "replaces": line,
        "launches": launches,
        "max_abs_err": max(max(r["max_abs_err"].values()) for r in mine
                           if r["dtype"] == str(torch.bfloat16)),
        "max_abs_err_fp32": max(max(r["max_abs_err"].values()) for r in mine
                                if r["dtype"] == str(torch.float32)),
        **{k: sum(r[k] for r in picked) for k in sums},
        "bound_by": max(bound, key=bound.get),
        "shape": f"5 sites of a net, B={batch}, bf16",
        "k_loop": "tensor cores (mma.sync bf16, fp32 sums)",
        "max_abs_err_fp32_in_bf16_taps": max(
            max(r["max_abs_err"].values()) for r in rows if r["kernel"] == name
            and r["tap"] == "bfloat16" and r["dtype"] == str(torch.float32)),
        "sass_hmma": hmma,
    }


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
    ptxas = start_ptxas(("group_norm_elu", "fused_loss"))
    port_kernels.load_all()
    log(f"  group_norm_elu, fused_loss and conv_gn_elu (the fused conv family: six "
        f"entry points, upsample included) built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    ptxas = finish_ptxas(ptxas, ("gn_elu_coop", "loss_forward", "loss_backward"))
    for fn, res in ptxas.items():
        log(f"  ptxas: {fn[:70]}: {res['registers']} registers, {res['spill_stores']} "
            f"bytes spill stores, {res['stack']} bytes stack")
    # the scalar route (VEC = 1: C % 8 != 0 or a pointer off 16 bytes, up to
    # 1024 threads a block) is reported; every other instantiation must
    # not spill
    spilling = {fn: res for fn, res in ptxas.items() if res["spill_stores"]
                and not ("gn_elu_coop" in fn and "Li1EE" in fn)}
    if spilling:
        raise AssertionError(f"the one-launch kernels spill: {spilling}")
    hmma_by_fn = sass_hmma()
    hmma = sum(hmma_by_fn.values())
    log(f"  SASS: {hmma} HMMA instructions in {len(hmma_by_fn)} instantiations of "
        f"conv3x3_stats_tc{{,_up}} (per instantiation {min(hmma_by_fn.values(), default=0)}"
        f"-{max(hmma_by_fn.values(), default=0)})")
    if not hmma_by_fn or min(hmma_by_fn.values()) == 0:
        raise AssertionError(f"conv3x3_stats_tc without tensor-core instructions: {hmma_by_fn}")

    cfg = kitti_config(**{"model.use_pallas_gn": True})
    cfg_fused = kitti_config(**{"model.use_pallas_gn": True, **FUSED})
    cfg_v1 = kitti_config(**{"model.use_pallas_gn": True, **FUSED_V1})
    cfg_fusion = kitti_config(**{"model.use_pallas_gn": True, **FUSION})
    cfg_all = kitti_config(**{"model.use_pallas_gn": True, **FUSED, **FUSION})
    gn = gnk.group_norm_elu
    n_gn = len(gn_sites(cfg.model))
    log("== 3. kernels vs plain (B=8, KITTI serving shapes)")
    rows = phase_kernels(cfg, gn)
    log(f"   and at the training batch (B={TRAIN_BATCH}, bf16, every site)")
    train_rows = phase_kernels_train(cfg, gn)

    log("== 4. slice: BatchedPredictor, full-width KITTI G-net, bf16")
    sd = init_params(cfg.model, torch.Generator().manual_seed(0))
    pred, serving_counts, serving = phase_slice(cfg, sd, {"group_norm_elu": n_gn})

    log("== 5. server")
    phase_server(cfg, pred)
    del pred

    log("== 6. fused loss kernels vs plain")
    loss_rows = phase_loss()

    log("== 7. GroupNorm+ELU gradients through the kernel")
    gn_grad_rows = phase_gn_grad()

    log(f"== 8. training: stage 1 then stage 2, full-width KITTI, bf16, "
        f"B={TRAIN_BATCH}")
    training, train_launches, _, s2, d_net = phase_train(
        cfg, TRAIN_STEPS, {"group_norm_elu": n_gn}, "training")

    log("== 9. one stage-2 step, card vs CPU, B=2")
    vs_cpu = phase_vs_cpu(cfg, s2, d_net)
    del s2, d_net

    log("== 10. fused conv3x3+GroupNorm+ELU kernels vs plain")
    conv_rows = phase_conv_kernels(
        cfg, ("conv_gn_elu", "conv_gn_elu_bt", "conv_gn_elu_s2", "fusion_bt"))

    log("== 11. gradients through the fused conv entry points")
    conv_grad_rows = phase_conv_grad(CONV_GRAD_CASES)

    log("== 12. slice with the fused kernels: serving, full width, bf16")
    fused_per_net = {"group_norm_elu": 6, "conv_gn_elu_bt": 5, "conv_gn_elu_s2": 5,
                     "fusion_bt": 5}
    _, fused_counts, serving_fused = phase_slice(cfg_fused, sd, fused_per_net,
                                                 "serving_fused", 16)
    log("   and with use_pallas_convgn alone (the per-image entry point)")
    _, v1_counts, serving_v1 = phase_slice(
        cfg_v1, sd, {"group_norm_elu": 16, "conv_gn_elu": 5}, "serving_v1", 8,
        timed=False)

    log(f"== 13. training with the fused kernels: stage 1 then stage 2, "
        f"B={TRAIN_BATCH}, bf16")
    training_fused, fused_train_launches, _, s2, d_net = phase_train(
        cfg_fused, FUSED_TRAIN_STEPS, fused_per_net, "training_fused")

    log("== 14. one stage-2 step with the fused kernels, card vs CPU, B=2")
    vs_cpu_fused = phase_vs_cpu(cfg_fused, s2, d_net)
    del s2, d_net

    log("== 15. upsample and fusion-block kernels vs plain")
    conv_rows += phase_conv_kernels(cfg, ("fusion_block", "upsample"))

    log("== 16. gradients through the upsample and fusion-block entry points")
    conv_grad_rows += phase_conv_grad(FUSION_GRAD_CASES)

    log("== 17. slice with use_pallas_fusion: serving, full width, bf16")
    fusion_per_net = {"group_norm_elu": n_gn - 10, "upsample": 5, "fusion_block": 5}
    _, fusion_counts, serving_fusion = phase_slice(cfg_fusion, sd, fusion_per_net,
                                                   "serving_fusion", 16)
    log("   and with every fused flag on (no GroupNorm site but the stem unfused)")
    _, all_counts, serving_all = phase_slice(
        cfg_all, sd, {"group_norm_elu": 1, "conv_gn_elu_s2": 5, "conv_gn_elu_bt": 5,
                      "fusion_bt": 5, "upsample": 5}, "serving_all", 8, timed=False)

    log(f"== 18. training with use_pallas_fusion: stage 1 then stage 2, "
        f"B={TRAIN_BATCH}, bf16")
    training_fusion, fusion_train_launches, _, s2, d_net = phase_train(
        cfg_fusion, TRAIN_STEPS, fusion_per_net, "training_fusion")

    log("== 19. one stage-2 step with use_pallas_fusion, card vs CPU, B=2")
    vs_cpu_fusion = phase_vs_cpu(cfg_fusion, s2, d_net)

    main_rows = [r for r in rows if r["dtype"] == str(torch.bfloat16)]
    per_fwd = {k: sum(r[k] * r["sites"] for r in main_rows)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    main_loss = loss_rows[0]
    path_launches = {"serving": serving_counts, **train_launches,
                     "serving_fused": fused_counts, "serving_v1": v1_counts,
                     **{f"{k}_fused": v for k, v in fused_train_launches.items()},
                     "serving_fusion": fusion_counts, "serving_all": all_counts,
                     **{f"{k}_fusion": v for k, v in fusion_train_launches.items()}}

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
    for name, line in (("conv_gn_elu", "gdn_tpu/kernels/conv_gn_elu.py:109"),
                       ("conv_gn_elu_bt", "gdn_tpu/kernels/conv_gn_elu.py:356"),
                       ("conv_gn_elu_s2", "gdn_tpu/kernels/conv_gn_elu.py:679"),
                       ("fusion_bt", "gdn_tpu/kernels/fusion_bt.py:226"),
                       ("fusion_block", "gdn_tpu/kernels/fusion_block.py:235"),
                       ("upsample", "gdn_tpu/kernels/upsample.py:148")):
        kernels.append(_family_entry(name, line, conv_rows, total(name), hmma))
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} was not launched on any main path")
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "chip_smoke.json"), "w") as f:
        json.dump({"device": smi, "torch": torch.__version__,
                   "per_shape": rows, "per_shape_train": train_rows,
                   "serving": serving, "loss": loss_rows,
                   "gn_grad": gn_grad_rows, "training": training,
                   "vs_cpu": vs_cpu, "conv": conv_rows, "conv_grad": conv_grad_rows,
                   "serving_fused": serving_fused, "serving_v1": serving_v1,
                   "training_fused": training_fused, "vs_cpu_fused": vs_cpu_fused,
                   "serving_fusion": serving_fusion, "serving_all": serving_all,
                   "training_fusion": training_fusion, "vs_cpu_fusion": vs_cpu_fusion,
                   "launches": path_launches, "timed_with_cuda_events": EVENT_TIMED,
                   "sass_hmma": hmma_by_fn, "ptxas": ptxas,
                   "kernels": kernels}, f, indent=1)
    if EVENT_TIMED:
        log(f"timed with CUDA events, the profiler having come back short: {EVENT_TIMED}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
