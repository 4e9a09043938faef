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
              same checks, the training shapes' times also from CUDA
              events with the calls queued back to back behind a spin
              (queued_ms, phase 26 (f)'s route);
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
 19. fusion vs CPU  phase 9 with use_pallas_fusion on;
 20. eval     the eval protocol (gdn_tpu_torch/evaluate.py) with phase 4's
              weights, bf16, full width: 64 images, RGB at 128x416, GT at
              KITTI's raw 375x1242 from numpy (seed 20; [0, 1.3 cap], 15%
              zeroed), batch 8, garg crop, cap 80.  One pass each:
              host-fed; device-cached (metrics equal to host-fed bit for
              bit, cuDNN's deterministic algorithms for the pair); u16 GT
              wire; flip TTA; median scaling; every fused flag on; the
              stage-1 D-net (random weights, seed 1) on the GT downsampled
              by nearest resize.  Launches asserted exactly (21 GN+ELU a
              batch unfused, 1 with every fused flag, the warm-up batch of
              each new Evaluator included).  The per-image metric columns
              of the card's eval step, host-fed and median-scaling, against
              the port's protocol on the CPU on the same fp32 predictions
              (atol 1e-5, rtol 1e-5).  Eval images/s (host clock, best of
              3 passes, device-cached and host-fed) and one profiled cached
              pass (device busy, idle share, launches a batch by kernel).
              Then train_stage2, 2 epochs of 3 steps at B=32 with 2
              validation batches and an in-training eval of 16 images each
              epoch: eval_rmse logged twice, the split read once (cached),
              the launches exact, a checkpoint written to stage2_best/ and
              scored by scripts/eval_torch.py --best;
 21. lifecycle  full-width KITTI: (a) stage 1, B=32, bf16, EMA 0.99,
              cuDNN's deterministic algorithms: 6 steps unbroken (twice)
              against 3 steps, an asynchronous checkpoint, a restore into
              a fresh net and optimizer and 3 more: parameters, EMA and
              Adam moments bit-identical; (b) train_stage2 with SIGTERM
              raised from the data iterator at batch 2: it stops after
              step 3, stage2/3.pt exists, the restore continues to step
              5; (c) grad_accum=2, stage 2, B=2, fp32: the first
              micro-step leaves params and EMA unchanged, the same batch
              twice equals one grad_accum=1 step (rtol 1e-5, atol 1e-7);
              (d) one stage-2 step at B=32, bf16, with and without remat,
              unfused, fused and fusion: loss terms equal, gradients
              within 5% of each tensor's largest, launches exact (the
              G-net's sites launch again in the recompute: 3 a site a
              step with the D-net's, 2 without remat), then peak
              allocated memory and ms/step of 3 training steps each;
              (e) scripts/train_torch.py --mode RtoD --ema_decay 0.99
              --eval_every 1 (2 x 3 steps, default keep_ckpts),
              scripts/eval_torch.py with and without --use_ema (metrics
              differ), scripts/serve_torch.py --ckpt_dir --use_ema --port
              0 answering one POST;
 22. disk     data from disk (gdn_tpu_torch/data): (a) a corpus written
              under smoke_out/disk: 512 KITTI pairs at 128x416
              (scripts/make_fixture.py --style scene, 16-bit depth PNGs,
              four processes), 64 KITTI eval images at the four raw sizes
              375x1242, 370x1224, 374x1238, 376x1241 (16 each: 12 with
              16-bit PNG GT, 4 with a velodyne .bin scan and KITTI's
              calibration files), 64 + 16 NYU frames at 480x640 with
              millimetre PNG depth; (b) host decode, images/s of
              KittiTrainDataset batches at B=32: native and PIL, wire and
              f32, cold and from a warm decode cache, with
              native_io.available() and the decoder each loader used;
              (c) stage 1 then stage 2, unfused, B=32, bf16, 8 steps each,
              through make_train_pipeline with augmentation, fed three
              ways: host-fed wire, the decode cache warm, the
              DeviceResidentDataset; ms/step and images/s beside phase 8's
              synthetic ones, launches exact, one profiled stage-2 step
              pulling its batch (device busy, idle share, launches), the
              pipeline's own device ops and time a batch, and the bytes
              it copies host to card; (d) one augmented batch, card vs
              CPU with the same draws: depth and mask bit for bit, RGB
              within 1e-6, then a stage-1 step on it at B=2, fp32, card
              vs CPU at phase 9's bounds; (e) scripts/train_torch.py
              --dataset kitti, stage 1, fp32, B=8, cuDNN deterministic: 6
              steps unbroken against 3, a checkpoint and --resume for 3:
              parameters and Adam moments bit-identical; (f) the eval list
              through an Evaluator (warm-up time a GT size), then
              scripts/eval_torch.py --dataset kitti --calib_dir host-fed
              and --device_cache (metrics equal), launches exact, the
              card's per-image metrics against the CPU protocol on the
              same fp32 predictions (rtol and atol 1e-5, a1-a3 within one
              pixel), and a fused (rows 5-7) stage-2 run from disk for 3
              steps with in-training eval over the list; (g) NYU: stage
              1 at 228x304, B=32, 3 steps, and the D-net's eval on the 16
              test frames (GT cropped to 426x560).
  23. tools  (a) the grain loader's counterpart on phase 22's corpus:
              host decode images/s at B=32, wire, at 0, 2, 4 and 8
              decode threads beside phase 22 (b)'s one-thread PIL loader;
              the first 6 batches at 0 and 4 threads hold grain's own
              record order (GRAIN_ORDER, computed with grain), two
              loaders yield them bit for bit, and their wire decode on
              the card equals the CPU's; stage 1 then stage 2, unfused,
              B=32, bf16, 8 steps each, host-fed through it at the best
              thread count, at 0 and at 2, beside phase 22 (c)'s
              host-fed and decode-cache rows, launches exact, one
              profiled stage-2 step at the best count; scripts/train_torch.py --loader grain --workers 4,
              fp32, B=8, cuDNN deterministic: 6 steps unbroken against 3,
              a checkpoint with the grain cursor and --resume for 3, bit
              for bit; (b) scripts/train_torch.py with the JAX flags
              (--lr_schedule cosine --warmup_steps 4 --grad_clip 1.0
              --tensorboard --model_dir), 6 steps a stage, unfused and
              with two sets of fused flags that together launch rows
              4-9 (CLI_ROUTES), launches exact, the logged learning
              rates against the schedule's formula, TensorBoard event
              files (or the logger's warning without the package); one
              stage-1 run with check_numerics (GuardedStep) against one
              without, alternated, ms/step; (c)
              scripts/convergence_torch.py --seeds 0 1 2 (300 steps a
              stage, 32x64, B=16): per-seed metrics, a1_mean within
              CONVERGENCE_A1_TOL of the port's own CPU run and of the JAX
              package's (the eval split is drawn on the host, so every
              device scores the same one); (d) scripts/profile_step_torch.py --mode
              RtoD --steps 3 (its top kernels and idle share beside phase
              8's profiled step), scripts/bench_torch.py,
              scripts/bench_eval_torch.py --device_cache and
              scripts/demo_torch.py on four of phase 22's eval images
              with --gif (maps at each input's size), each once.
  24. artifacts  (a) torch.export artifacts of the full-width G-net
              (random weights from seed 0, batch 8, bf16) exported on the
              card in four configurations: unfused, every fused flag,
              use_pallas_fusion, use_pallas_convgn (together rows 1 and
              4-9), and the int8 G-net of (b); seconds and MB of each;
              all five loaded in one fresh process that imports torch,
              the kernels and serving, never gdn_tpu_torch.models, which
              serves 20 uint8 images through BatchedPredictor.from_artifact
              on both wires: depths against BatchedPredictor on the same
              state_dict (bit for bit, else rtol 1e-5 with the count of
              pixels that differ), launches a batch by kernel equal to
              the checkpoint predictor's and to phases 4, 12 and 17;
              (b) int8: scales calibrated on the card on
              synthetic_calibration_batches and on the CPU, in fp32
              (each within 1%) and in bf16 (within phase 3's bf16
              rtol, 0.05: a scale is the absmax of bf16 GN+ELU
              outputs, and bf16 ulps are 0.4-0.8%); 20 images through
              the int8 predictor and its artifact (21 GN+ELU launches a
              batch, nothing else); against the CPU int8 run of the same
              weights and scales, in fp32 and in bf16: the conv of each
              of the 21 sites on the CPU run's input (int32 sums equal,
              output within rtol 1e-6), the depth at a relative mean
              |d| < 0.05 (an input within rounding of a .5 step flips,
              and flips carry downstream into more), and against the
              card's bf16 forward (relative mean |d| < 0.05); int8
              beside bf16 in the same
              call: ms a batch, device busy ms, idle share, launches by
              kernel; (c) scripts/eval_torch.py --quantize int8 on phase
              22's eval list, calibrated on its train list, beside phase
              22 (f)'s bf16 metrics; (d) scripts/serve_torch.py
              --artifact answering one POST.
  25. variants  the model variants, full width: (a) serving at batch 8
              (random weights of init_params, seed 0, the deconv init),
              kitti_config with upsample="deconv", multiscale_heads
              (the main path: bilinear init, no deconv GN, the bare ELU
              through elu_saveout) unfused (16 GN+ELU launches a batch
              and no other of the nine kernels), with the fused flags
              (1 GN+ELU, 5 s2, 5 bt, 5 fusion_bt) and with
              use_pallas_fusion (11 GN+ELU, 5 fusion-block, 0 upsample),
              then phase 4's resize_conv net in the same call: ms a
              batch, device busy, idle share and all launches a batch;
              the deconv depth card vs CPU in fp32 (phase 4's bound) and
              card bf16 vs CPU bf16 within 1% of max_depth; (b) both
              training stages at B=32, 6 steps each, unfused and fused,
              the scales term in the log, launches exact, then one
              stage-2 step card vs CPU (phase 9, the scales term among
              the terms); (c) the variant grid (VARIANT_GRID) at B=2:
              add fusion unfused and with use_pallas_convgn_bt (10 bt a
              net), norm="none" and relu / gelu / leaky_relu with every
              fused flag on (no launch of the nine model kernels),
              deconv_gn (21 GN+ELU a net), the lecun deconv init, and
              deconv at NYU's 228x304 (the deconv output resized down to
              the skips' odd sizes): one stage-2 step each, card (fp32)
              vs CPU, depth, terms and stem gradients at phase 9's
              bounds, launches exact; (d) scripts/train_torch.py
              --upsample deconv --multiscale, 3 steps a stage,
              scripts/eval_torch.py --ckpt_dir on it (config.json brings
              the variant back), scripts/export_artifact_torch.py of its
              stage 2 loaded in a fresh process (phase 24's loader):
              depth and launches a batch against the checkpoint
              predictor.
  26. knobs  the training knobs at full width (kitti_config, bf16,
              random weights: the D-net's and the G-net's init_params
              draws of seeds 26 and 27, the G-net holding the D-net's
              decoder): (a) one stage-2 step at B=32 from the same
              weights in each configuration of KNOBS, the two-net step
              (phase 8's) first, then fused_guidance, with
              fused_guidance_vjp, with fused_encoders, with
              fused_encoders and the fused flags (fusion_bt at 2B = 64),
              and fused_guidance with use_pallas_fusion (the upsample and
              fusion-block kernels at 2B): launches a step exact, ms/step
              (host clock, 3 steps after one), peak allocated memory,
              one profiled step (device busy, idle share, all launches); (b)
              each of them at B=2, card (fp32, TF32 off) against the CPU
              at phase 9's bounds, and each fused one against the
              two-net step with the same model flags on the card (terms
              rtol 1e-5, stem gradients phase 9's bound); (c)
              steps_per_call=4 in both stages, unfused, B=32, EMA 0.99,
              cuDNN deterministic: one call against 4 single steps from
              the same state, parameters, EMA and Adam moments
              bit-identical, launches a call exact, ms an update; (d)
              stage 2 at B=32, unfused, remat off and each remat_policy
              the port runs (REMAT_RUNS): gradients against remat off
              within 5% of each tensor's largest (bit-identical where
              so), launches a step exact with the recompute's, ms/step,
              peak memory and a profiled step; (e) scripts/train_torch.py
              --steps_per_call 2 --fused_guidance, 4 steps a stage; (f)
              the GroupNorm+ELU kernel against its plain version at every
              shape of the paired encoder ladder (B=32, C = 2 x the
              encoder's width, 16 groups, bf16), as phase 3, the time
              from queued events (late in the process CUPTI has recorded
              none of these launches).
  27. parallel  data parallel and FSDP (gdn_tpu_torch/parallel), full
              width, bf16, random weights (init_params seeds 27 and 28,
              the G-net holding the D-net's decoder), P27_STEPS batches of
              32 drawn on the host with sparse masks, rows 0-15 ~15%
              valid and rows 16-31 ~40% (the ranks' counts differ by more
              than 2x), against one process in the same phase: (a)
              train_stage1 then train_stage2 over two ranks that share the
              card (spawned by parallel.multihost.run_ranks, gloo, 16 rows
              a rank): each rank's launches a stage equal to one
              process's (kernels 1-3 in both ranks), the first step's
              terms within phase 9's fp32 rtol 1e-4, every step's within
              1e-3 (bf16 Adam updates flip the sign of near-zero
              gradients; phase 9's bf16 bound is 5%), the first update's
              gradients within 5% of each tensor's largest (the bf16
              gradient bound of phases 21 (d) and 26 (d)), and one
              stage-2 step in fp32 (TF32 off) at phase 9's fp32 bounds:
              terms rtol 1e-4, gradients 1e-3 of each tensor's largest;
              ms/step on
              each rank's host clock and a profiled stage-2 step on each
              rank (device busy, idle share, and kernels 1-3 by name in
              its own profile) beside one process's; (b)
              stage 2 under FSDP (FSDP2 over the same two ranks): the same
              checks, and each rank's bytes of the trained parameters and
              their Adam moments against one process's (about half);
              (c) one DP stage-2 step with every fused flag, and one with
              use_pallas_convgn + use_pallas_fusion: kernels 4-9 launch in
              the ranks, as many as in one process; (d) one rank over
              NCCL: a stage-1 step through the data-parallel path against
              the plain step, cuDNN deterministic: gradients and terms
              bit for bit; (e) evaluate() of the G-net (fp32) on 16 images
              of the synthetic eval split, batch 8, over the two ranks:
              the metrics of one process within 1e-5, a1-a3 within one
              pixel; (f) ShardedDeviceDataset over the two ranks on phase
              22's corpus (each rank through a decode cache of its own):
              its index stream and the rows of its first batches on the
              card equal the CPU port's.
  28. tp_sp  tensor and spatial parallelism (gdn_tpu_torch/parallel/
              tensor.py, spatial.py), full width, bf16, phase 27's
              weights and batches, two ranks sharing the card over gloo
              (one spawn): first, in this process, the split GN+ELU
              kernel (gn_rows_sums + gn_rows_apply, on a spatial axis of
              extent 1) against its plain version and the plain fp32
              statistics at every site shape a spatial rank of the B=32
              128x416 nets holds (half the rows), two calls equal bit for
              bit, each call two device kernels and nothing else (the
              fold inside gn_rows_sums, no torch reduce), with device
              times, the plan and bounds; then (a) TP, model_devices=2:
              train_stage1 then train_stage2 against phase 27's one
              process, bf16 at phase
              9's 5% (the terms of every step, the first update's
              gradients of each tensor's largest), and one fp32 step a
              stage at phase 9's fp32 bounds (terms 1e-4, gradients
              1e-3), each rank launching the
              GN+ELU kernel as often as one process (42 a stage-2 step)
              on half the channels of each site and the loss kernels once
              each a step, and holding half the parameter and Adam bytes
              (0.45-0.55); (b) one TP stage-2 step with every fused flag
              and one with use_pallas_convgn + use_pallas_fusion:
              kernels 4-9 launch in both ranks, terms against one
              process; (c) SP, spatial_devices=2 at 128x416: both stages
              against one process as (a), the bf16 gradients at 5% with
              the loss's multi-scale gradient term off (with it a few
              sparse coarse pixels weigh 1/count each, and bf16 flips
              their signs: see NO_GRAD_TERM; the fp32 step holds the full
              loss's gradients), the split GN+ELU
              kernel launched (42 a stage-2 step) and neither the
              one-launch GN+ELU kernel nor the loss kernels (the loss
              takes its plain terms on a spatial mesh, as in the JAX
              package); (d) a tall image (B=8, 512x416) under SP: each
              rank's peak allocated memory above its state below 0.65x
              one process's; (e) scripts/train_torch.py --model_devices
              2 and --spatial_devices 2 run in phase 29 (d), at once with
              its commands.  ms/step and device busy are printed per
              rank, with no bound.
  29. split_knobs  every knob on every mesh (A10c), full width, two
              ranks sharing the card over gloo (one spawn), each case
              one step from the same weights and batch (B=8) against one
              process in this call (first, in this process, the split
              GN+ELU kernel against _rows_plain at each rank's uneven
              shard of every NYU site and the paired ladder's 2G-group
              sites, two calls bit for bit, one profiled pass of a call
              a shape: the two kernels and nothing else): fp32 terms
              within 1e-4 and gradients
              within 1e-3 of each tensor's largest, bf16 terms within
              phase 28's 5% and the bf16 gradients within its 5% or,
              where larger, one process's own bf16-to-fp32 gap (see
              F32's note), every
              rank's launches by kernel (TP: one process's; SP: its
              GN+ELU launches as split ones, no one-launch GN+ELU and no
              loss kernel), ms/step of a second bf16 step: (a) the
              three variant nets of P29_GRID (stage 1) and fused
              guidance with its backward and the paired encoders (stage
              2), each under TP and under SP; (b) nyu_config() at
              228x304 under SP (levels 228 / 114 / 57 / 29 / 15 / 8 split
              unevenly), stage 2: the split GN+ELU kernel on uneven
              shards and the row gathers counted; (c) fused guidance
              under FSDP over the two ranks, and FSDP on data 2 x spatial
              2 over four ranks (a second spawn), stage 1; (d)
              scripts/train_torch.py under TP and under SP (phase 28
              (e)'s commands), under TP with --upsample deconv and under
              SP with --norm none at NYU's size, the four at once, each
              checkpoint restored in this process and run once.
  30. migration  the .pth migration path, full width, bf16: (a) the
              D-net's random weights (init_params, seed 30) and phase
              4's G-net written as reference-style .pth files, every key
              renamed by a key map (``enc.layer3.kernel``), wrapped as
              {"state_dict": ...} with DataParallel's ``module.`` keys,
              imported by scripts/import_pth_torch.py on the card: the
              checkpoints' weights equal the sources bit for bit; (b)
              BatchedPredictor on the stage-2 import, batch 8, 16 images:
              depth bit-identical to the source weights' (cuDNN
              deterministic), 21 GN+ELU launches a batch; (c)
              scripts/train_torch.py --mode RtoD --stage1_ckpt on the
              stage-1 import, B=32, 2 steps: every logged term equal to
              --stage1_pth of the source D-net's bit for bit, 42 GN+ELU
              and one loss forward and backward a step; (d)
              scripts/export_pth_torch.py of both imports under the same
              key maps: the files imported, key for key, bit for bit;
              (e) the phase's seconds and launches.

Any failure ends the run with a nonzero exit.  The last lines are the
kernels' JSON line, the nvidia-smi line, and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Per-shape numbers also go to smoke_out/chip_smoke.json (phase 23's under
"tools", phase 24's under "artifacts", phase 25's under "variants",
phase 26's under "knobs", phase 27's under "parallel", phase 28's under
"tp_sp", phase 29's under "split_knobs", phase 30's under "migration"),
the profiles to
smoke_out/{serving,training}{,_fused,_fusion}_profile.txt,
smoke_out/knobs_*_profile.txt,
smoke_out/eval_profile.txt and smoke_out/disk_*_profile.txt.
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
            "conv_gn_elu_bt", "conv_gn_elu_s2", "fusion_bt", "fusion_block", "upsample",
            "group_norm_elu_rows")
FUSED_COUNTERS = COUNTERS[3:9]  # kernels 4-9: the fused conv family
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


SPIN_CYCLES = 200_000_000  # ~100 ms of torch.cuda._sleep at the H100's ~2 GHz


def queued_ms(fns, iters=20):
    """Mean device ms of one call, the calls queued back to back: they are
    enqueued behind a spin kernel (``torch.cuda._sleep``), so CUDA events
    around them time the card alone, not the host's pace between
    launches.  Raises when the host took longer to enqueue them than the
    spin lasted (the queue ran dry: the time would include the host)."""
    for f in fns[:3]:
        f()
    torch.cuda.synchronize()
    n = max(iters, len(fns))
    spun, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    spun.record()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for i in range(n):
        fns[i % len(fns)]()
    host_ms = 1e3 * (time.perf_counter() - t0)
    end.record()
    end.synchronize()
    if host_ms >= spun.elapsed_time(start):
        raise RuntimeError(f"queued_ms: the host took {host_ms:.1f} ms to enqueue {n} calls, "
                           f"longer than the {spun.elapsed_time(start):.1f} ms spin")
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
    the profiler keeps coming back short, the calls are timed with CUDA
    events instead, queued back to back behind a spin (``queued_ms``:
    the card's time with no gaps between launches), and ``what`` is
    noted in EVENT_TIMED.  A dict given as ``split`` receives {kernel
    name: device ms of one call} and, under "launches", the kernels one
    call launches."""
    for f in fns[:3]:
        f()
    n = max(iters, len(fns))

    def loop():
        for i in range(n):
            fns[i % len(fns)]()

    try:
        # every call launches a kernel; CUPTI on the H100 has recorded one
        # kernel fewer than launched in a loop of one-kernel calls, session
        # after session, and three fewer of 20 late in a long process, so
        # up to a fifth short is taken and each kernel is averaged over its
        # own recorded launches
        _, kernels, _ = profiled(loop, min_calls=n - max(1, n // 5))
    except ProfilerShort:
        EVENT_TIMED.append(what)
        log(f"  (timing {what or 'this call'} with CUDA events instead)")
        return queued_ms(fns, iters)
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
        # the same calls queued back to back, timed with events (phase 26
        # (f)'s route), beside the profiler's time
        row["queued_ms"] = queued_ms([lambda: gn(x, scale, bias, g)])
        rows.append(row)
        log(f"  {what}: max|k-p| {err:.3g}, stats {serr:.3g}; {plan_text(plan)}")
        log(f"    device us: kernel {row['ms']*1e3:.1f} (queued events "
            f"{row['queued_ms']*1e3:.1f}) bound {row['bound_ms']*1e3:.1f} "
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
           fk.fused_fusion_bt, fb.fused_fusion_block, uk.fused_upsample_conv,
           gnk.group_norm_elu_rows)
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


def phase_slice(cfg, sd, per_batch, tag="serving", n_images=20, timed=True,
                bf16_cpu=False):
    """Serve ``n_images`` through BatchedPredictor under ``cfg``; the
    kernels must launch exactly ``per_batch`` times a batch; depth is
    held against the same weights and flags on the CPU.  With
    ``bf16_cpu`` the card's bf16 depth is also held against the CPU's
    bf16 forward of the same two images, within 1% of max_depth (the
    bound of the CPU tests for the JAX package against the port)."""
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
    if bf16_cpu:
        cpu16 = BatchedPredictor(cfg, sd, batch_size=2, device="cpu").predict(images[:2])
        d16 = np.abs(depth[:2] - cpu16)
        info["card_bf16_vs_cpu_bf16_max_m"] = float(d16.max())
        log(f"  vs CPU bf16: card bf16 max|d| {d16.max():.3g} m, mean {d16.mean():.3g} m "
            f"(bound {0.01 * cfg.model.max_depth:.3g} m)")
        if d16.max() > 0.01 * cfg.model.max_depth:
            raise AssertionError("bf16 depth beyond 1% of max_depth of the CPU's bf16")
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
    from gdn_tpu_torch.checkpoint import init_params, load_params
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
            d_net.load_state_dict(load_params(os.path.join(ckpt, "stage1")))
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


EVAL_IMAGES = 64
EVAL_GT = (375, 1242)  # KITTI's raw GT size
EVAL_BATCH = 8
EVAL_TRAIN_STEPS = 3  # in-training eval: 2 epochs of 3 steps
EVAL_VAL_STEPS = 2
EVAL_TRAIN_IMAGES = 16
EVAL_TOL = dict(atol=1e-5, rtol=1e-5)  # card vs CPU protocol on the same fp32 preds


def eval_split(cfg, n=EVAL_IMAGES, seed=20):
    """``n`` samples: RGB at the train size, GT at KITTI's raw size, both
    from numpy with a fixed seed; GT uniform in [0, 1.3 cap] with 15% of
    its pixels zeroed (invalid), so the cap and the mask have work."""
    rng = np.random.default_rng(seed)
    h, w = cfg.model.image_size
    rgb = rng.uniform(0, 1, (n, h, w, 3)).astype(np.float32)
    gt = rng.uniform(0, 1.3 * cfg.eval.cap, (n, *EVAL_GT)).astype(np.float32)
    gt[rng.uniform(size=gt.shape) < 0.15] = 0.0
    return [{"rgb": rgb[i:i + 1], "gt": gt[i:i + 1]} for i in range(n)]


def eval_pass(ev, split, what, per_batch, warm):
    """One Evaluator pass (``split`` None: the cached split) between
    zeroed and read launch counts; ``per_batch`` launches for each of
    the split's batches and for ``warm`` warm-up batches."""
    from gdn_tpu_torch import metrics as M

    batches = -(-EVAL_IMAGES // EVAL_BATCH)
    torch.cuda.synchronize()
    reset_counts()
    out = ev.run(split, verbose=False)
    torch.cuda.synchronize()
    counts = read_counts()
    expect_counts(what, counts, **{k: v * (batches + warm) for k, v in per_batch.items()})
    if not all(np.isfinite(out[k]) for k in M.METRIC_NAMES):
        raise AssertionError(f"{what}: metrics not finite: {out}")
    log(f"  {what}: " + " ".join(f"{k}={out[k]:.4f}" for k in M.METRIC_NAMES)
        + f"; {out['fps']:.1f} images/s; launches { {k: v for k, v in counts.items() if v} }")
    return out, counts


def protocol_vs_cpu(cfg, forward, split, what):
    """The per-image metric columns of the card's eval step against the
    port's protocol run on the CPU on the same fp32 predictions (the
    step's ``return_preds``), for the first two batches."""
    from gdn_tpu_torch.evaluate import _batch_iter, _wire_encoders, make_eval_step

    card = make_eval_step(cfg, forward, EVAL_GT, return_preds=True, device="cuda")
    cpu = make_eval_step(cfg, lambda pred: pred, EVAL_GT, device="cpu")
    worst = 0.0
    batches = _batch_iter(split[:2 * EVAL_BATCH], EVAL_BATCH, None, *_wire_encoders(cfg))
    for _, rgb, gt, _, _ in batches:
        cols, preds = card(rgb.cuda(), gt.cuda())
        want = cpu(preds.cpu()[..., None], gt).numpy()
        got = cols.cpu().numpy()
        np.testing.assert_allclose(got, want, **EVAL_TOL, err_msg=what)
        worst = max(worst, float(np.abs(got - want).max()))
    log(f"  {what}: card vs CPU protocol on the same fp32 predictions, 16 images x 8 "
        f"metrics: max|d| {worst:.3g} (atol {EVAL_TOL['atol']:g}, rtol {EVAL_TOL['rtol']:g})")
    return worst


def profile_eval(ev, tag="eval"):
    """One device-cached pass under torch.profiler: the card's busy share
    of the wall time and the launches a batch by kernel name."""
    batches = -(-EVAL_IMAGES // EVAL_BATCH)
    try:
        prof, kernels, wall = profiled(lambda: ev.run(None, verbose=False), cpu=True)
    except ProfilerShort as e:
        log(f"  profile of {tag}: not measured ({e})")
        return None
    busy_ms = sum(us for us, _ in kernels.values()) / 1e3
    with open(os.path.join(OUT, f"{tag}_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    out = {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
           "idle_share": 1 - busy_ms / (wall * 1e3),
           "launches_per_batch": sum(n for _, n in kernels.values()) / batches,
           "launches_per_batch_by_kernel": {k: n / batches
                                            for k, (_, n) in kernels.items()},
           "top_kernels_us": [(k[:90], us, n) for k, (us, n) in top]}
    log(f"  profile of one cached pass ({EVAL_IMAGES} images): wall {out['wall_ms']:.1f} ms, "
        f"device busy {busy_ms:.2f} ms (idle {out['idle_share']:.1%}), "
        f"{out['launches_per_batch']:.1f} launches a batch")
    for k, us, n in out["top_kernels_us"]:
        log(f"    {us / 1e3:8.3f} ms  x{n:<5d} ({n / batches:g} a batch) {k}")
    return out


def phase_eval(cfg, cfg_all, sd):
    """Phase 20: the eval protocol on the card at full width (see the
    module docstring)."""
    from gdn_tpu_torch import metrics as M
    from gdn_tpu_torch.checkpoint import init_params, latest_step
    from gdn_tpu_torch.config import _with
    from gdn_tpu_torch.data.synthetic import SyntheticDataset
    from gdn_tpu_torch.evaluate import Evaluator, Stage1Split
    from gdn_tpu_torch.models import DtoDNet, RtoDNet
    from gdn_tpu_torch.train.loop import train_stage2
    from gdn_tpu_torch.train.steps import make_eval_forward
    from gdn_tpu_torch.utils.logging import MetricLogger

    os.makedirs(OUT, exist_ok=True)
    ev_over = {"eval.batch_size": EVAL_BATCH, "eval.crop": "garg", "eval.cap": 80.0}
    cfg = _with(cfg, **ev_over)
    h, w = cfg.model.image_size
    split = eval_split(cfg)
    n_gn = len(gn_sites(cfg.model))
    unfused = {"group_norm_elu": n_gn}
    net = RtoDNet(cfg.model)
    net.load_state_dict(sd)
    net = net.cuda()
    fwd = make_eval_forward(cfg, net)
    out, launches = {}, {}

    def same(a, b, what):
        if any(a[k] != b[k] for k in M.METRIC_NAMES):
            raise AssertionError(f"{what}: {a} != {b}")
        log(f"  {what}: equal bit for bit")

    # the passes compared bit for bit run cuDNN's deterministic algorithms
    torch.backends.cudnn.deterministic = True
    ev = Evaluator(cfg, fwd)
    out["host_fed"], launches["eval_host_fed"] = eval_pass(ev, split, "host-fed", unfused, 1)
    ev.cache_dataset(split)
    log(f"  cached {ev.cached_images} images, {ev.cached_bytes / 2**20:.1f} MiB of wire "
        "format on the card")
    out["cached"], launches["eval_cached"] = eval_pass(ev, None, "device-cached", unfused, 0)
    same(out["cached"], out["host_fed"], "device-cached vs host-fed metrics")
    # the u16 wire ships round(gt * 256) counts: its pass equals an f32 pass
    # on the GT rounded so on the host
    c16 = _with(cfg, **{"eval.gt_wire": "u16"})
    out["u16"], launches["eval_u16"] = eval_pass(Evaluator(c16, fwd), split, "gt_wire u16",
                                                 unfused, 1)
    rounded = [{"rgb": s["rgb"], "gt": (np.round(s["gt"] * 256.0) / 256.0).astype(np.float32)}
               for s in split]
    same(out["u16"], ev.run(rounded, verbose=False), "u16 wire vs f32 wire of the rounded GT")
    torch.backends.cudnn.deterministic = False
    out["protocol_err"] = protocol_vs_cpu(cfg, fwd, split, "host-fed protocol")

    tta = make_eval_forward(cfg, net, flip_tta=True)
    out["flip_tta"], launches["eval_flip_tta"] = eval_pass(
        Evaluator(cfg, tta), split, "flip_tta (one 2B forward a batch)", unfused, 1)

    cms = _with(cfg, **{"eval.median_scaling": True})
    out["median_scaling"], launches["eval_median"] = eval_pass(
        Evaluator(cms, fwd), split, "median_scaling", unfused, 1)
    out["protocol_err_median"] = protocol_vs_cpu(cms, fwd, split, "median-scaling protocol")

    call = _with(cfg_all, **ev_over)
    net_all = RtoDNet(call.model)
    net_all.load_state_dict(sd)
    fused = {"group_norm_elu": 1, "conv_gn_elu_s2": 5, "conv_gn_elu_bt": 5,
             "fusion_bt": 5, "upsample": 5}
    out["all_fused"], launches["eval_all_fused"] = eval_pass(
        Evaluator(call, make_eval_forward(call, net_all.cuda())), split,
        "every fused flag", fused, 1)
    # bf16 through other kernels: the metrics of the same weights agree to 2%
    for k in ("abs_rel", "rmse", "a1"):
        a, b = out["all_fused"][k], out["host_fed"][k]
        if abs(a - b) > 0.02 * abs(b):
            raise AssertionError(f"every fused flag {k}={a} vs unfused {b}")
    del net_all

    d_net = DtoDNet(cfg.model)
    d_sd = init_params(cfg.model, torch.Generator().manual_seed(1), in_channels=1)
    d_net.load_state_dict(d_sd)
    out["stage1"], launches["eval_stage1"] = eval_pass(
        Evaluator(cfg, make_eval_forward(cfg, d_net.cuda())), Stage1Split(split, (h, w)),
        "stage 1 (D-net reconstruction)", unfused, 1)
    del d_net

    fps = {"cached": [ev.run(None, verbose=False)["fps"] for _ in range(3)],
           "host_fed": [ev.run(split, verbose=False)["fps"] for _ in range(3)]}
    out["images_per_s"] = {k: max(v) for k, v in fps.items()}
    out["images_per_s_runs"] = fps
    log(f"  eval images/s (host clock, best of 3 passes of {EVAL_IMAGES}, batch "
        f"{EVAL_BATCH}, GT {EVAL_GT[0]}x{EVAL_GT[1]}): device-cached "
        f"{out['images_per_s']['cached']:.1f}, host-fed {out['images_per_s']['host_fed']:.1f}"
        f" (runs {fps})")
    out["profile"] = profile_eval(ev)
    del ev, net

    # in-training eval: one Evaluator, the split cached once, best tracking
    ckpt = os.path.join(OUT, "eval_train")
    shutil.rmtree(ckpt, ignore_errors=True)
    ct = _with(cfg, **{"train.steps_per_epoch": EVAL_TRAIN_STEPS,
                       "train.log_every": EVAL_TRAIN_STEPS, "train.ckpt_dir": ckpt,
                       "data.batch_size": TRAIN_BATCH})
    small = split[:EVAL_TRAIN_IMAGES]
    calls = []
    jsonl = os.path.join(OUT, "eval_train.jsonl")
    if os.path.exists(jsonl):
        os.remove(jsonl)
    logger = MetricLogger(prefix="stage2", jsonl_path=jsonl)
    torch.cuda.synchronize()
    reset_counts()
    train_stage2(ct, SyntheticDataset(TRAIN_BATCH, h, w, ct.model.max_depth, seed=0,
                                      device="cuda"),
                 d_sd, epochs=2, logger=logger,
                 val_iter=SyntheticDataset(TRAIN_BATCH, h, w, ct.model.max_depth, seed=1,
                                           device="cuda"),
                 val_steps=EVAL_VAL_STEPS, eval_dataset=lambda: calls.append(1) or small,
                 eval_every=1)
    torch.cuda.synchronize()
    launches["eval_train"] = counts = read_counts()
    logger.close()
    steps, evals = 2 * EVAL_TRAIN_STEPS, 2 * EVAL_TRAIN_IMAGES // EVAL_BATCH + 1
    expect_counts("in-training eval", counts, fused_loss_fwd=steps + 2 * EVAL_VAL_STEPS,
                  fused_loss_bwd=steps,
                  group_norm_elu=n_gn * (2 * steps + 2 * EVAL_VAL_STEPS + evals))
    recs = [json.loads(line) for line in open(jsonl)]
    rmse = [r["eval_rmse"] for r in recs if "eval_rmse" in r]
    if len(rmse) != 2 or not all(np.isfinite(rmse)):
        raise AssertionError(f"eval_rmse of the two epochs: {rmse}")
    if sum("val_total" in r for r in recs) != 2:
        raise AssertionError("validation did not log both epochs")
    if len(calls) != 1:
        raise AssertionError(f"the eval split was read {len(calls)} times, not once")
    if latest_step(os.path.join(ckpt, "stage2_best")) is None:
        raise AssertionError("no checkpoint in stage2_best")
    res = load_script("eval_torch").main(["--dataset", "synthetic", "--ckpt_dir", ckpt, "--best",
                       "--max_images", str(EVAL_TRAIN_IMAGES)])
    if not all(np.isfinite(res[k]) for k in M.METRIC_NAMES):
        raise AssertionError(f"eval_torch.py --best: {res}")
    out["in_training"] = {"eval_rmse": rmse, "launches": counts, "split_reads": len(calls),
                          "eval_torch_best": res}
    log(f"  in-training eval: eval_rmse {rmse} over 2 epochs of {EVAL_TRAIN_STEPS} steps, "
        f"split read once and cached, launches "
        f"{ {k: v for k, v in counts.items() if v} }; eval_torch.py --best rmse "
        f"{res['rmse']:.4f}")
    return out, launches


LIFE_STEPS = 6  # phase 21 (a): 6 steps unbroken; 3, a checkpoint, 3 more
LIFE_PREEMPT_AT = 2  # phase 21 (b): SIGTERM while the data iterator yields batch 2
LIFE_TIMED = 3  # phase 21 (d): timed steps a configuration, after one untimed
GRAD_TOL_BF16 = 0.05  # phase 9's bf16 bound, per tensor: of its largest magnitude
ACCUM_TOL = dict(rtol=1e-5, atol=1e-7)  # tests/test_grad_accum.py's bound


def load_script(name):
    """scripts/<name>.py as a module (its main() is the command line)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _snapshot(state):
    """Parameters, EMA, Adam moments, gradient mean and counts of a
    TrainState, copied to the host."""
    opt = [state.optimizer.state.get(p, {}) for p in state.params]
    return {"params": {k: v.detach().cpu() for k, v in state.net.state_dict().items()},
            "ema": {k: v.cpu() for k, v in (state.ema or {}).items()},
            "exp_avg": {i: s["exp_avg"].cpu() for i, s in enumerate(opt) if s},
            "exp_avg_sq": {i: s["exp_avg_sq"].cpu() for i, s in enumerate(opt) if s},
            "counts": (state.step, state.updates)}


def _snap_diff(a, b):
    """{part: largest |a - b|} of two snapshots; raises when they differ
    in keys or counts."""
    if a["counts"] != b["counts"]:
        raise AssertionError(f"(step, updates) {a['counts']} vs {b['counts']}")
    out = {}
    for part in ("params", "ema", "exp_avg", "exp_avg_sq"):
        if a[part].keys() != b[part].keys():
            raise AssertionError(f"{part}: keys differ")
        out[part] = max([(a[part][k].float() - b[part][k].float()).abs().max().item()
                         for k in a[part]], default=0.0)
    return out


def counts_text(counts):
    """The nonzero launch counts, for a log line."""
    return str({k: v for k, v in counts.items() if v})


def _quiet(prefix):
    from gdn_tpu_torch.utils.logging import MetricLogger

    return MetricLogger(prefix=prefix, stream=io.StringIO())


def life_resume(cfg, root, n_gn):
    """Phase 21 (a): stage 1, an unbroken run against one stopped at half
    way, checkpointed asynchronously, restored into a fresh state and
    continued; bit for bit under cuDNN's deterministic algorithms."""
    from gdn_tpu_torch.checkpoint import restore_checkpoint, wait_for_checkpoints
    from gdn_tpu_torch.config import _with
    from gdn_tpu_torch.data.synthetic import SyntheticDataset
    from gdn_tpu_torch.train.loop import stage1_state, train_stage1

    c = _with(cfg, **{"train.ema_decay": 0.99, "train.log_every": 100,
                      "data.batch_size": TRAIN_BATCH, "train.ckpt_dir": ""})
    h, w = c.model.image_size
    whole = _with(c, **{"train.steps_per_epoch": LIFE_STEPS})
    half = _with(c, **{"train.steps_per_epoch": LIFE_STEPS // 2, "train.ckpt_dir": root,
                       "train.async_ckpt": True})

    def data(skip=0):
        ds = SyntheticDataset(TRAIN_BATCH, h, w, c.model.max_depth, seed=21, device="cuda")
        ds.seek(skip)
        return ds

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    runs = [_snapshot(train_stage1(whole, data(), epochs=1, logger=_quiet("stage1")))
            for _ in range(2)]
    train_stage1(half, data(), epochs=1, logger=_quiet("stage1"))
    wait_for_checkpoints(root)
    stage_dir = os.path.join(root, "stage1")
    state = restore_checkpoint(stage_dir, stage1_state(half))
    if state.step != LIFE_STEPS // 2:
        raise AssertionError(f"restored at step {state.step}")
    state = train_stage1(half, data(state.step), epochs=1, state=state,
                         logger=_quiet("stage1"))
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    counts = read_counts()
    steps = 3 * LIFE_STEPS
    expect_counts("lifecycle resume", counts, group_norm_elu=n_gn * steps,
                  fused_loss_fwd=steps, fused_loss_bwd=steps)
    again = _snap_diff(runs[0], runs[1])
    resumed = _snap_diff(_snapshot(state), runs[0])
    log(f"  (a) resume, stage 1, B={TRAIN_BATCH}, bf16, EMA 0.99, cuDNN deterministic: "
        f"two unbroken runs of {LIFE_STEPS} steps differ by {again}; "
        f"{LIFE_STEPS // 2} steps + async checkpoint + restore into a fresh net and "
        f"optimizer + {LIFE_STEPS // 2} steps vs unbroken: {resumed}; launches "
        f"{counts_text(counts)} ({time.perf_counter() - t0:.1f} s)")
    if any(resumed.values()):
        raise AssertionError(f"resumed run not bit-identical to the unbroken one: {resumed}")
    return state, counts, {"unbroken_twice_max_diff": again, "resumed_max_diff": resumed}


def life_preempt(cfg, root, d_sd, n_gn):
    """Phase 21 (b): SIGTERM from the data iterator during stage 2."""
    import signal

    from gdn_tpu_torch.checkpoint import latest_step, restore_checkpoint
    from gdn_tpu_torch.config import _with
    from gdn_tpu_torch.data.synthetic import SyntheticDataset
    from gdn_tpu_torch.train.loop import stage2_state, train_stage2

    c = _with(cfg, **{"train.steps_per_epoch": 50, "train.ckpt_dir": root,
                      "train.log_every": 100, "data.batch_size": TRAIN_BATCH})
    h, w = c.model.image_size

    def data(skip=0):
        ds = SyntheticDataset(TRAIN_BATCH, h, w, c.model.max_depth, seed=22, device="cuda")
        ds.seek(skip)
        return ds

    def preempting():
        for i, batch in enumerate(data()):
            if i == LIFE_PREEMPT_AT:
                signal.raise_signal(signal.SIGTERM)
            yield batch

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    state = train_stage2(c, preempting(), d_sd, epochs=2, logger=_quiet("stage2"))
    stop = LIFE_PREEMPT_AT + 1  # the step in flight when the signal came
    stage_dir = os.path.join(root, "stage2")
    if state.step != stop or latest_step(stage_dir) != stop:
        raise AssertionError(f"stopped at {state.step}, newest checkpoint "
                             f"{latest_step(stage_dir)}; expected {stop}")
    restored = restore_checkpoint(stage_dir, stage2_state(c, d_sd))
    if _snap_diff(_snapshot(restored), _snapshot(state))["params"]:
        raise AssertionError("the restored G-net is not the preempted one")
    cont = _with(c, **{"train.steps_per_epoch": 2, "train.ckpt_dir": ""})
    final = train_stage2(cont, data(restored.step), d_sd, epochs=1, state=restored,
                         logger=_quiet("stage2"))
    torch.cuda.synchronize()
    counts = read_counts()
    steps = stop + 2
    expect_counts("lifecycle preemption", counts, group_norm_elu=2 * n_gn * steps,
                  fused_loss_fwd=steps, fused_loss_bwd=steps)
    if final.step != stop + 2:
        raise AssertionError(f"the restore continued to step {final.step}")
    log(f"  (b) preemption, stage 2: SIGTERM at batch {LIFE_PREEMPT_AT} stopped the run "
        f"after step {stop}; stage2/{stop}.pt written; restored and continued to step "
        f"{final.step}; launches {counts_text(counts)} "
        f"({time.perf_counter() - t0:.1f} s)")
    return counts, {"stopped_at": stop, "continued_to": final.step}


def life_accum(cfg, d_sd, n_gn):
    """Phase 21 (c): grad_accum=2 on the same batch twice against one
    grad_accum=1 step, stage 2, B=2, fp32, TF32 off."""
    from gdn_tpu_torch.config import _with
    from gdn_tpu_torch.data.synthetic import synthetic_batch
    from gdn_tpu_torch.models import DtoDNet
    from gdn_tpu_torch.train.loop import stage2_state
    from gdn_tpu_torch.train.steps import make_stage2_step

    c = _with(cfg, **{"model.dtype": "float32", "train.ema_decay": 0.99,
                      "train.grad_clip": 1.0})
    ca = _with(c, **{"train.grad_accum": 2})
    h, w = c.model.image_size
    batch = synthetic_batch(torch.Generator(device="cuda").manual_seed(23), 2, h, w,
                            c.model.max_depth)
    d_net = DtoDNet(c.model)
    d_net.load_state_dict(d_sd)
    d_net = d_net.cuda().requires_grad_(False)
    ref, acc = stage2_state(c, d_sd), stage2_state(ca, d_sd)
    start = _snapshot(acc)
    torch.backends.cudnn.deterministic = True  # the same batch, the same gradient
    torch.cuda.synchronize()
    reset_counts()
    make_stage2_step(ca)(acc, d_net, batch)
    first = _snapshot(acc)
    if first["params"].keys() != start["params"].keys() or any(
            not torch.equal(first[p][k], start[p][k]) for p in ("params", "ema")
            for k in start[p]):
        raise AssertionError("the first micro-step moved the parameters or the EMA")
    make_stage2_step(ca)(acc, d_net, batch)
    make_stage2_step(c)(ref, d_net, batch)
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    counts = read_counts()
    expect_counts("lifecycle grad_accum", counts, group_norm_elu=2 * n_gn * 3,
                  fused_loss_fwd=3, fused_loss_bwd=3)
    a, r = _snapshot(acc), _snapshot(ref)
    if (a["counts"], r["counts"]) != ((2, 1), (1, 1)):
        raise AssertionError(f"(step, updates): accumulated {a['counts']}, plain {r['counts']}")
    diff = _snap_diff({**a, "counts": r["counts"]}, r)
    for part in ("params", "ema", "exp_avg", "exp_avg_sq"):
        for k in r[part]:
            np.testing.assert_allclose(a[part][k].numpy(), r[part][k].numpy(),
                                       err_msg=f"grad_accum {part} {k}", **ACCUM_TOL)
    log(f"  (c) grad_accum=2, stage 2, B=2, fp32: the first micro-step left params and "
        f"EMA unchanged; the same batch twice vs one grad_accum=1 step, max|d| {diff} "
        f"(bound rtol {ACCUM_TOL['rtol']}, atol {ACCUM_TOL['atol']}); launches "
        f"{counts_text(counts)}")
    return counts, {"max_diff": diff}


def life_remat(cfgs, d_sd):
    """Phase 21 (d): one stage-2 step at B=32, bf16, with and without
    remat, in each configuration of ``cfgs`` ({tag: (cfg, per_net)}):
    loss terms equal, gradients within GRAD_TOL_BF16, launches exact;
    then peak memory and ms/step of the training step."""
    from gdn_tpu_torch.checkpoint import init_params, transfer_stage1_decoder
    from gdn_tpu_torch.config import _with
    from gdn_tpu_torch.data.synthetic import synthetic_batch
    from gdn_tpu_torch.models import DtoDNet, RtoDNet
    from gdn_tpu_torch.train.state import TrainState
    from gdn_tpu_torch.train.steps import _stage2_loss, make_stage2_step

    out, launches = {}, {}
    g_sd = None
    for tag, (cfg, per_net) in cfgs.items():
        h, w = cfg.model.image_size
        if g_sd is None:
            g_sd = transfer_stage1_decoder(
                init_params(cfg.model, torch.Generator().manual_seed(24)),
                {k: v.cpu() for k, v in d_sd.items()})
        batch = synthetic_batch(torch.Generator(device="cuda").manual_seed(24), TRAIN_BATCH,
                                h, w, cfg.model.max_depth)

        def nets(c):
            g, d = RtoDNet(c.model), DtoDNet(c.model)
            g.load_state_dict(g_sd)
            d.load_state_dict(d_sd)
            g, d = g.cuda(), d.cuda().requires_grad_(False)
            return g, d

        res = {}
        torch.backends.cudnn.deterministic = True
        for remat in (False, True):
            c = _with(cfg, **{"train.remat": remat})
            g, d = nets(c)
            g.decoder.requires_grad_(False)
            _stage2_loss(g, d, batch, c)["total"].backward()  # cuDNN's first calls
            g.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            reset_counts()
            terms = _stage2_loss(g, d, batch, c)
            terms["total"].backward()
            torch.cuda.synchronize()
            counts = read_counts()
            nets_a_step = 3 if remat else 2  # the G-net (again under remat) and the D-net
            expect_counts(f"{tag} remat={remat}", counts, fused_loss_fwd=1, fused_loss_bwd=1,
                          **{k: v * nets_a_step for k, v in per_net.items()})
            res[remat] = ({k: float(v.detach()) for k, v in terms.items()},
                          {k: p.grad.detach().clone() for k, p in g.named_parameters()
                           if p.requires_grad}, counts)
            launches[f"lifecycle_remat_{tag}_{remat}"] = counts
            del g, d, terms
        torch.backends.cudnn.deterministic = False
        (t0, g0, c0), (t1, g1, c1) = res[False], res[True]
        if t0 != t1:
            raise AssertionError(f"{tag}: loss terms with remat {t1} vs without {t0}")
        rel = max(((g1[k] - g0[k]).abs().max() / g0[k].abs().max().clamp_min(1e-30)).item()
                  for k in g0)
        if rel > GRAD_TOL_BF16:
            raise AssertionError(f"{tag}: remat gradients off by {rel:.3g} of their max")
        row = {"terms_equal": True, "grad_max_rel_diff": rel,
               "launches_per_step": {str(r): {k: v for k, v in res[r][2].items() if v}
                                     for r in (False, True)}}
        # the training step as the trainer runs it: timed, and its peak memory
        for remat in (False, True):
            c = _with(cfg, **{"train.remat": remat})
            g, d = nets(c)
            state = TrainState(g, c.train, 10, freeze_decoder=True)
            step = make_stage2_step(c)
            step(state, d, batch)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t_start = time.perf_counter()
            for _ in range(LIFE_TIMED):
                step(state, d, batch)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t_start) / LIFE_TIMED
            peak = torch.cuda.max_memory_allocated()
            counts = read_counts()
            expect_counts(f"{tag} remat={remat} timed", counts,
                          fused_loss_fwd=LIFE_TIMED, fused_loss_bwd=LIFE_TIMED,
                          **{k: v * (3 if remat else 2) * LIFE_TIMED
                             for k, v in per_net.items()})
            launches[f"lifecycle_remat_{tag}_{remat}_timed"] = counts
            row[f"remat_{remat}"] = {"ms_per_step": ms, "peak_allocated_bytes": peak,
                                     "allocated_before_bytes": base,
                                     "peak_above_before_bytes": peak - base}
            del g, d, state, step
        out[tag] = row
        r0, r1 = row["remat_False"], row["remat_True"]
        log(f"  (d) remat, {tag}: loss terms equal, gradients within {rel:.3g} of their "
            f"max, launches a step {row['launches_per_step']['False']} -> "
            f"{row['launches_per_step']['True']}; step {r0['ms_per_step']:.1f} -> "
            f"{r1['ms_per_step']:.1f} ms (host clock, {LIFE_TIMED} steps), peak "
            f"{r0['peak_allocated_bytes'] / 2**30:.2f} -> "
            f"{r1['peak_allocated_bytes'] / 2**30:.2f} GiB allocated "
            f"({r0['peak_above_before_bytes'] / 2**30:.2f} -> "
            f"{r1['peak_above_before_bytes'] / 2**30:.2f} GiB above the state)")
    return out, launches


def life_cli(stage1_dir, root):
    """Phase 21 (e): train_torch.py RtoD with an EMA and in-training
    eval, eval_torch.py with and without --use_ema, serve_torch.py
    --ckpt_dir --use_ema answering one POST."""
    from PIL import Image

    from gdn_tpu_torch import metrics as M
    from gdn_tpu_torch.checkpoint import latest_step

    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.synchronize()
    reset_counts()
    state = load_script("train_torch").main([
        "--mode", "RtoD", "--dataset", "synthetic", "--ema_decay", "0.99",
        "--eval_every", "1", "--eval_max_images", "8", "--epochs", "2",
        "--steps_per_epoch", "3", "--log_every", "3", "--ckpt_dir", root,
        "--stage1_ckpt", stage1_dir])
    files = {d: sorted(os.listdir(os.path.join(root, d))) for d in ("stage2", "stage2_best")}
    if state.step != 6 or files["stage2"] != ["3.pt", "6.pt", "config.json"] or len(
            files["stage2_best"]) != 2:
        raise AssertionError(f"train_torch.py RtoD: step {state.step}, files {files}")
    ev = load_script("eval_torch")
    base = ["--dataset", "synthetic", "--ckpt_dir", root, "--max_images", "16"]
    plain, ema = ev.main(base), ev.main([*base, "--use_ema"])
    if not all(np.isfinite(ema[k]) for k in M.METRIC_NAMES) or all(
            plain[k] == ema[k] for k in M.METRIC_NAMES):
        raise AssertionError(f"eval_torch.py --use_ema {ema} vs without {plain}")
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"  (e) train_torch.py --mode RtoD --ema_decay 0.99 --eval_every 1: 2 x 3 steps, "
        f"{files}; eval_torch.py rmse {plain['rmse']:.4f}, with --use_ema "
        f"{ema['rmse']:.4f}; launches {counts_text(counts)}")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "scripts", "serve_torch.py"), "--ckpt_dir", root,
         "--use_ema", "--port", "0", "--serve_batch", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT)
    try:
        lines = []
        deadline = time.time() + 180
        while time.time() < deadline:
            lines.append(proc.stdout.readline())
            if "serving on" in lines[-1] or proc.poll() is not None:
                break
        if "serving on" not in lines[-1]:
            raise AssertionError("serve_torch.py did not start: " + "".join(lines))
        port = int(lines[-1].split("http://127.0.0.1:")[1].split(" ")[0])
        rgb = np.random.default_rng(21).integers(0, 255, (128, 416, 3), np.uint8)
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, format="PNG")
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            depth = np.load(io.BytesIO(r.read()))
        if depth.shape != (128, 416) or not np.isfinite(depth).all():
            raise AssertionError(f"serve_torch.py answered {depth.shape}")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    log(f"  (e) serve_torch.py --ckpt_dir --use_ema --port 0: answered one POST, depth "
        f"{depth.shape}, mean {depth.mean():.3f} m ({time.perf_counter() - t0:.1f} s with "
        "its start)")
    return counts, {"eval": plain, "eval_ema": ema, "files": files}


def phase_lifecycle(cfg, cfg_fused, cfg_fusion):
    """Phase 21: checkpoints, resume, preemption, grad_accum, remat and
    the command line around them (see the module docstring)."""
    root = os.path.join(OUT, "lifecycle")
    shutil.rmtree(root, ignore_errors=True)
    n_gn = len(gn_sites(cfg.model))
    t0 = time.perf_counter()
    out, launches = {}, {}
    d_state, launches["lifecycle_resume"], out["resume"] = life_resume(cfg, root, n_gn)
    d_sd = {k: v.detach() for k, v in d_state.net.state_dict().items()}
    del d_state
    launches["lifecycle_preempt"], out["preempt"] = life_preempt(cfg, root, d_sd, n_gn)
    launches["lifecycle_accum"], out["grad_accum"] = life_accum(cfg, d_sd, n_gn)
    out["device"] = smi_line()
    log(f"  (d) remat: ms/step and peak memory on {out['device']}")
    out["remat"], remat_launches = life_remat({
        "unfused": (cfg, {"group_norm_elu": n_gn}),
        "fused": (cfg_fused, {"group_norm_elu": 6, "conv_gn_elu_bt": 5,
                              "conv_gn_elu_s2": 5, "fusion_bt": 5}),
        "fusion": (cfg_fusion, {"group_norm_elu": n_gn - 10, "upsample": 5,
                                "fusion_block": 5})}, d_sd)
    launches.update(remat_launches)
    launches["lifecycle_cli"], out["cli"] = life_cli(
        os.path.join(root, "stage1"), os.path.join(OUT, "lifecycle_cli"))
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 21 took {out['seconds']:.1f} s")
    return out, launches


DISK_PAIRS = 512  # KITTI training pairs at 128x416, written by scripts/make_fixture.py
DISK_WRITERS = 4  # make_fixture.py processes, 128 pairs each
DISK_STEPS = 8  # a stage per feed: one pass over the corpus in two stages; host clock 2-8
DISK_DECODE_BATCHES = 4  # (b): batches of 32 per decode measurement
DISK_EVAL_SIZES = ((375, 1242), (370, 1224), (374, 1238), (376, 1241))  # KITTI's raw sizes
DISK_EVAL_PER_SIZE, DISK_VELO_PER_SIZE = 16, 4  # 12 PNG and 4 velodyne GT a size
DISK_EVAL_BATCH = 8
DISK_RESUME = (6, 3, 8)  # (e): steps unbroken, steps before the stop, batch
DISK_FUSED_STEPS = 3
NYU_PAIRS, NYU_TEST, NYU_STEPS = 64, 16, 3
# KITTI's published calibration of the 2011_09_26 drive (camera 2, velodyne)
KITTI_CALIB = {
    "calib_cam_to_cam.txt": (
        "calib_time: 09-Jan-2012 13:57:47\n"
        "R_rect_00: 9.999239e-01 9.837760e-03 -7.445048e-03 -9.869795e-03 9.999421e-01 "
        "-4.278459e-03 7.402527e-03 4.351614e-03 9.999631e-01\n"
        "P_rect_02: 7.215377e+02 0.000000e+00 6.095593e+02 4.485728e+01 0.000000e+00 "
        "7.215377e+02 1.728540e+02 2.163791e-01 0.000000e+00 0.000000e+00 1.000000e+00 "
        "2.745884e-03\n"),
    "calib_velo_to_cam.txt": (
        "calib_time: 15-Mar-2012 11:37:16\n"
        "R: 7.533745e-03 -9.999714e-01 -6.166020e-04 1.480249e-02 7.280733e-04 "
        "-9.998902e-01 9.998621e-01 7.523790e-03 1.480755e-02\n"
        "T: -4.069766e-03 -7.631618e-02 -2.717806e-01\n"),
}


def _smooth_rgb(rng, h, w):
    """A smooth RGB field with noise, uint8: bilinear upsampling of a
    coarse random grid (compresses and decodes like a photograph, not
    like noise)."""
    from PIL import Image

    coarse = rng.integers(0, 256, (max(2, h // 24), max(2, w // 24), 3), np.uint8)
    img = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BILINEAR), np.int16)
    return np.clip(img + rng.integers(-8, 9, img.shape), 0, 255).astype(np.uint8)


def write_disk_corpus(root):
    """Phase 22 (a): the KITTI training corpus (scripts/make_fixture.py
    --style scene, DISK_WRITERS processes), the KITTI eval list at the
    four raw sizes with 16-bit PNG and velodyne GT and the calibration,
    and NYU's 480x640 frames with millimetre PNG depth.  Returns the
    dataset roots and the seconds taken."""
    from PIL import Image

    t0 = time.perf_counter()
    shutil.rmtree(root, ignore_errors=True)
    kitti, nyu = os.path.join(root, "kitti"), os.path.join(root, "nyu")
    per = DISK_PAIRS // DISK_WRITERS
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "scripts", "make_fixture.py"), "--out",
         os.path.join(kitti, f"p{s}"), "--n", str(per), "--style", "scene", "--seed", str(s)],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for s in range(DISK_WRITERS)]
    rng = np.random.default_rng(22)
    calib = os.path.join(kitti, "calib")
    os.makedirs(calib, exist_ok=True)
    os.makedirs(os.path.join(kitti, "eval"), exist_ok=True)
    for name, text in KITTI_CALIB.items():
        with open(os.path.join(calib, name), "w") as f:
            f.write(text)
    lines = []
    for (h, w) in DISK_EVAL_SIZES:
        for i in range(DISK_EVAL_PER_SIZE):
            stem = f"eval/{h}x{w}_{i:02d}"
            Image.fromarray(_smooth_rgb(rng, h, w)).save(os.path.join(kitti, stem + ".png"))
            if i < DISK_VELO_PER_SIZE:
                n = 120_000  # a 64-beam scan
                pts = np.stack([rng.uniform(-10, 80, n), rng.uniform(-40, 40, n),
                                rng.uniform(-2.5, 1.5, n), rng.uniform(0, 1, n)], -1)
                pts.astype(np.float32).tofile(os.path.join(kitti, stem + ".bin"))
                lines.append(f"{stem}.png {stem}.bin")
            else:  # LiDAR-like: a ramp, valid on ~5% of pixels in the lower 2/3
                depth = np.linspace(80, 3, h)[:, None] * rng.uniform(0.7, 1.0, (1, w))
                keep = (rng.uniform(size=(h, w)) < 0.08) & (np.arange(h)[:, None] > h // 3)
                gt = np.where(keep, np.round(depth * 256), 0).astype(np.uint16)
                Image.fromarray(gt).save(os.path.join(kitti, stem + "_gt.png"))
                lines.append(f"{stem}.png {stem}_gt.png")
    with open(os.path.join(kitti, "eval.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    os.makedirs(os.path.join(nyu, "f"), exist_ok=True)
    nyu_lines = []
    for i in range(NYU_PAIRS + NYU_TEST):
        Image.fromarray(_smooth_rgb(rng, 480, 640)).save(os.path.join(nyu, f"f/{i:03d}.png"))
        depth = np.linspace(1.0, 9.0, 640)[None, :] * rng.uniform(0.8, 1.1, (480, 1))
        depth[rng.uniform(size=depth.shape) < 0.1] = 0.0  # Kinect holes
        Image.fromarray(np.round(depth * 1000).astype(np.uint16)).save(
            os.path.join(nyu, f"f/{i:03d}_d.png"))
        nyu_lines.append(f"f/{i:03d}.png f/{i:03d}_d.png")
    with open(os.path.join(nyu, "train.txt"), "w") as f:
        f.write("\n".join(nyu_lines[:NYU_PAIRS]) + "\n")
    with open(os.path.join(nyu, "test.txt"), "w") as f:
        f.write("\n".join(nyu_lines[NYU_PAIRS:]) + "\n")
    train = []
    for s, p in enumerate(procs):
        _, err = p.communicate(timeout=600)
        if p.returncode != 0:
            raise AssertionError(f"make_fixture.py --seed {s} failed: {err[-2000:]}")
        with open(os.path.join(kitti, f"p{s}", "train.txt")) as f:
            train += [" ".join(f"p{s}/{x}" for x in line.split()) for line in f if line.strip()]
    with open(os.path.join(kitti, "train.txt"), "w") as f:
        f.write("\n".join(train) + "\n")
    seconds = time.perf_counter() - t0
    log(f"  (a) wrote {len(train)} KITTI pairs at 128x416 (make_fixture.py --style scene, "
        f"{DISK_WRITERS} processes), {len(lines)} eval images at "
        f"{', '.join(f'{h}x{w}' for h, w in DISK_EVAL_SIZES)} "
        f"({DISK_EVAL_PER_SIZE - DISK_VELO_PER_SIZE} 16-bit PNG + {DISK_VELO_PER_SIZE} "
        f"velodyne GT a size) and {NYU_PAIRS} + {NYU_TEST} NYU frames at 480x640 in "
        f"{seconds:.1f} s; os.cpu_count() = {os.cpu_count()}")
    return kitti, nyu, seconds


def _decode_rate(loader, batches=DISK_DECODE_BATCHES):
    it = iter(loader)
    t0 = time.perf_counter()
    n = sum(next(it)["rgb"].shape[0] for _ in range(batches))
    return n / (time.perf_counter() - t0)


def disk_decode(kitti, cache_root):
    """Phase 22 (b): images/s of KittiTrainDataset batches (B=32) on the
    host, native and PIL, wire and f32, cold and from a decode cache."""
    from gdn_tpu_torch.data import native_io
    from gdn_tpu_torch.data.kitti import KittiTrainDataset

    avail = native_io.available()
    log(f"  (b) native_io.available() = {avail}"
        + ("" if avail else f"; make -C native said: {native_io.BUILD_LOG.strip()[-600:]}"))
    out = {"native_available": avail, "cpu_count": os.cpu_count()}
    for use_native in (True, False):
        kw = dict(size=(128, 416), batch_size=TRAIN_BATCH, seed=0, use_native=use_native)
        decoder = KittiTrainDataset(kitti, "train.txt", **kw).decoder
        if use_native and decoder != "native":
            log("  (b) the native decoder is unavailable: its loaders decode with PIL")
            continue
        cache = os.path.join(cache_root, f"decode_{decoder}")
        shutil.rmtree(cache, ignore_errors=True)
        rates = {f"{wire}_cold": _decode_rate(KittiTrainDataset(kitti, "train.txt", wire=wire,
                                                                **kw))
                 for wire in ("auto", "f32")}
        rates["cache_fill"] = _decode_rate(KittiTrainDataset(kitti, "train.txt",
                                                             cache_dir=cache, **kw))
        for wire in ("auto", "f32"):
            rates[f"{wire}_warm_cache"] = _decode_rate(
                KittiTrainDataset(kitti, "train.txt", wire=wire, cache_dir=cache, **kw))
        out[decoder] = rates
        log(f"  (b) decoder {decoder}: images/s at B={TRAIN_BATCH} over "
            f"{DISK_DECODE_BATCHES} batches: " + ", ".join(f"{k} {v:.0f}"
                                                          for k, v in rates.items()))
    return out


def _pipeline_ops(cfg, loader):
    """What the pipeline does to one batch on the card (the upload, the
    wire decode, the augmentation), profiled alone: device ms, kernels
    and copies by name, and the bytes it copies host -> card."""
    from gdn_tpu_torch.data.augment import apply_augment, augment_params, decode_wire_batch
    from gdn_tpu_torch.data.pipeline import upload

    dev = torch.device("cuda")
    it = iter(loader)
    host = next(it)

    def run():
        b = {k: upload(v, dev) for k, v in host.items()}
        b = decode_wire_batch(b, max_depth=cfg.model.max_depth, depth_scale=256.0)
        params = augment_params(torch.Generator().manual_seed(0), TRAIN_BATCH, cfg.data)
        flat = upload(torch.stack(list(params.values())), dev)
        return apply_augment(b, dict(zip(params, flat)), cfg.data)

    run()
    before = upload.bytes
    run()
    h2d = upload.bytes - before
    if not isinstance(host["rgb"], np.ndarray):  # the device cache: its index upload
        before = upload.bytes
        next(it)
        h2d += upload.bytes - before
    try:
        _, kernels, _ = profiled(run)
    except ProfilerShort as e:
        return {"h2d_bytes": h2d, "profile": f"not measured ({e})"}
    by_name = {}
    for k, (_, n) in kernels.items():
        by_name[k[:90]] = by_name.get(k[:90], 0) + n
    return {"h2d_bytes": h2d, "device_ms": sum(us for us, _ in kernels.values()) / 1e3,
            "ops": sum(n for _, n in kernels.values()), "by_name": by_name}


def profile_disk_step(cfg, state, d_net, pipe, tag):
    """One stage-2 step that pulls its batch from the pipeline, under
    torch.profiler (the prefetch thread keeps working meanwhile)."""
    from gdn_tpu_torch.train.steps import make_stage2_step

    step = make_stage2_step(cfg)
    step(state, d_net, next(pipe))
    try:
        prof, kernels, wall = profiled(lambda: step(state, d_net, next(pipe)), cpu=True)
    except ProfilerShort as e:
        log(f"  profile of {tag}: not measured ({e})")
        return None
    busy_ms = sum(us for us, _ in kernels.values()) / 1e3
    with open(os.path.join(OUT, f"{tag}_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / (wall * 1e3),
            "kernel_launches": sum(n for _, n in kernels.values())}


def disk_train(cfg, kitti, cache_root, synthetic, n_gn):
    """Phase 22 (c): stage 1 then stage 2 from disk, B=32, bf16, through
    make_train_pipeline with augmentation, in three feeds."""
    from gdn_tpu_torch.config import _with
    from gdn_tpu_torch.data.device_cache import DeviceResidentDataset
    from gdn_tpu_torch.data.kitti import KittiTrainDataset
    from gdn_tpu_torch.data.pipeline import make_train_pipeline
    from gdn_tpu_torch.train.loop import train_stage1, train_stage2
    from gdn_tpu_torch.utils.logging import MetricLogger

    h, w = cfg.model.image_size
    cache = os.path.join(cache_root, "train_cache")
    shutil.rmtree(cache, ignore_errors=True)
    t0 = time.perf_counter()
    filled = sum(b["rgb"].shape[0] for b in KittiTrainDataset(
        kitti, "train.txt", (h, w), TRAIN_BATCH, loop=False, cache_dir=cache))
    fill_s = time.perf_counter() - t0
    log(f"  (c) decode cache filled: {filled} pairs in {fill_s:.2f} s "
        f"({filled / fill_s:.0f} images/s)")
    out, launches = {"cache_fill_images_per_s": filled / fill_s}, {}
    for feed in ("host_fed", "decode_cache", "device_cache"):
        tag = f"disk_{feed}"
        ckpt = os.path.join(OUT, tag) if feed == "host_fed" else ""
        if ckpt:
            shutil.rmtree(ckpt, ignore_errors=True)
        c = _with(cfg, **{"train.steps_per_epoch": DISK_STEPS, "train.log_every": DISK_STEPS,
                          "train.ckpt_dir": ckpt, "data.batch_size": TRAIN_BATCH})
        loader = KittiTrainDataset(kitti, "train.txt", (h, w), TRAIN_BATCH, seed=0,
                                   cache_dir=cache if feed != "host_fed" else "")
        row = {"decoder": loader.decoder}
        if feed == "device_cache":
            t0 = time.perf_counter()
            loader = DeviceResidentDataset(loader, device="cuda")
            torch.cuda.synchronize()
            row["setup_s"] = time.perf_counter() - t0
            row["resident_bytes"] = loader.resident_bytes
        row["pipeline"] = _pipeline_ops(c, loader)
        loader.seek(0)  # each feed trains on the loader's order from its start
        pipe = make_train_pipeline(c, loader, device="cuda")
        for stage in ("stage1", "stage2"):
            jsonl = os.path.join(OUT, f"{tag}_{stage}.jsonl")
            if os.path.exists(jsonl):
                os.remove(jsonl)
            logger = MetricLogger(prefix=stage, jsonl_path=jsonl, stream=io.StringIO())
            torch.cuda.synchronize()
            reset_counts()
            if stage == "stage1":
                s1 = train_stage1(c, pipe, epochs=1, logger=logger)
                d_net = s1.net.requires_grad_(False)
            else:
                s2 = train_stage2(c, pipe, d_net, epochs=1, logger=logger)
            torch.cuda.synchronize()
            launches[f"{tag}_{stage}"] = counts = read_counts()
            logger.close()
            nets = 1 if stage == "stage1" else 2
            expect_counts(f"{tag} {stage}", counts, fused_loss_fwd=DISK_STEPS,
                          fused_loss_bwd=DISK_STEPS, group_norm_elu=n_gn * nets * DISK_STEPS)
            rec = [json.loads(line) for line in open(jsonl)][-1]
            if not all(np.isfinite(v) for k, v in rec.items() if k not in ("t", "step")):
                raise AssertionError(f"{tag} {stage}: {rec}")
            ips = rec["imgs_per_sec"]
            row[stage] = {"images_per_s": ips, "ms_per_step": 1e3 * TRAIN_BATCH / ips,
                          "total": rec["total"]}
        row["profile"] = profile_disk_step(c, s2, d_net, pipe, tag)
        pipe.close()
        del s1, s2, d_net, loader
        out[feed] = row
        syn = {k: synthetic[k]["ms_per_step"] for k in ("stage1", "stage2")}
        p, pr = row["pipeline"], row["profile"] or {}
        log(f"  (c) {feed} ({row['decoder']} decode): stage 1 "
            f"{row['stage1']['ms_per_step']:.1f} ms/step ({row['stage1']['images_per_s']:.1f} "
            f"images/s), stage 2 {row['stage2']['ms_per_step']:.1f} ms/step "
            f"({row['stage2']['images_per_s']:.1f} images/s); phase 8 synthetic "
            f"{syn['stage1']:.1f} / {syn['stage2']:.1f} ms/step; one stage-2 step: wall "
            f"{pr.get('wall_ms', float('nan')):.1f} ms, device busy "
            f"{pr.get('device_busy_ms', float('nan')):.2f} ms (idle "
            f"{pr.get('idle_share', float('nan')):.1%}), {pr.get('kernel_launches')} launches; "
            f"the pipeline a batch: {p.get('ops')} device ops, {p.get('device_ms', 0):.3f} ms, "
            f"{p['h2d_bytes']} bytes H2D"
            + (f"; corpus {row['resident_bytes'] / 2**20:.1f} MiB on the card in "
               f"{row['setup_s']:.2f} s" if feed == "device_cache" else ""))
    return out, launches


def disk_vs_cpu(cfg, kitti):
    """Phase 22 (d): one wire batch decoded and augmented on the card and
    on the CPU with the same values; then one stage-1 step on it at B=2,
    fp32, card against CPU (phase 9's bounds)."""
    from gdn_tpu_torch.checkpoint import init_params
    from gdn_tpu_torch.config import _with
    from gdn_tpu_torch.data.augment import apply_augment, augment_params, decode_wire_batch
    from gdn_tpu_torch.data.kitti import KittiTrainDataset
    from gdn_tpu_torch.data.pipeline import host_tensor, upload
    from gdn_tpu_torch.models import DtoDNet
    from gdn_tpu_torch.train.steps import _stage1_loss

    host = next(iter(KittiTrainDataset(kitti, "train.txt", cfg.model.image_size, TRAIN_BATCH,
                                       seed=3)))
    params = augment_params(torch.Generator().manual_seed(22), TRAIN_BATCH, cfg.data)
    kw = dict(max_depth=cfg.model.max_depth, depth_scale=256.0)
    cpu = apply_augment(decode_wire_batch({k: host_tensor(v) for k, v in host.items()}, **kw),
                        params, cfg.data)
    dev = torch.device("cuda")
    card = apply_augment(decode_wire_batch({k: upload(v, dev) for k, v in host.items()}, **kw),
                         {k: v.to(dev) for k, v in params.items()}, cfg.data)
    card = {k: v.cpu() for k, v in card.items()}
    for k in ("depth", "mask"):
        if not torch.equal(card[k], cpu[k]):
            raise AssertionError(f"augmented {k}: card != CPU")
    rgb_err = (card["rgb"] - cpu["rgb"]).abs().max().item()
    if rgb_err > 1e-6:
        raise AssertionError(f"augmented rgb: card vs CPU {rgb_err:.3g} > 1e-6")
    c = _with(cfg, **{"model.dtype": "float32"})
    sd = init_params(c.model, torch.Generator().manual_seed(5), in_channels=1)
    batch = {k: v[:2].contiguous() for k, v in cpu.items()}
    watch = ("encoder.stem.Conv_0.kernel", "encoder.stem.gn_scale")
    res = {}
    for name, d in (("cpu", "cpu"), ("card", "cuda")):
        net = DtoDNet(c.model)
        net.load_state_dict(sd)
        net = net.to(d)
        terms = _stage1_loss(net, {k: v.to(d) for k, v in batch.items()}, c)
        terms["total"].backward()
        grads = dict(net.named_parameters())
        res[name] = ({k: float(v.detach()) for k, v in terms.items()},
                     {k: grads[k].grad.detach().cpu() for k in watch})
    out = {"rgb_max_abs_err": rgb_err, "terms": {k: v[0] for k, v in res.items()}}
    for k, v in res["card"][0].items():
        if abs(v - res["cpu"][0][k]) > 1e-4 * abs(res["cpu"][0][k]):
            raise AssertionError(f"stage-1 step from disk: card {k}={v} vs CPU {res['cpu'][0][k]}")
    for k in watch:
        got, want = res["card"][1][k], res["cpu"][1][k]
        out[f"grad_rel_err {k}"] = rel = ((got - want).abs().max() / want.abs().max()).item()
        if rel > 1e-3:
            raise AssertionError(f"stage-1 step from disk: grad {k} off by {rel:.3g} of its max")
    log(f"  (d) one augmented B={TRAIN_BATCH} batch, same values: depth and mask equal bit "
        f"for bit card vs CPU, RGB max|d| {rgb_err:.3g} (bound 1e-6); stage-1 step at B=2, "
        f"fp32: terms within rtol 1e-4, grads " + ", ".join(
            f"{k} {out[f'grad_rel_err {k}']:.3g}" for k in watch) + " of their max (bound 1e-3)")
    return out


def disk_resume(kitti, cache_root):
    """Phase 22 (e): scripts/train_torch.py --dataset kitti, stage 1,
    fp32: an unbroken run against one stopped, checkpointed and
    --resume-d; bit for bit under cuDNN's deterministic algorithms."""
    n, k, b = DISK_RESUME
    root = os.path.join(OUT, "disk_resume")
    shutil.rmtree(root, ignore_errors=True)
    train = load_script("train_torch")
    common = ["--mode", "DtoD", "--dataset", "kitti", "--data_path", kitti, "--dtype",
              "float32", "--batch_size", str(b), "--steps_per_epoch", str(k), "--log_every",
              str(k), "--decode_cache", os.path.join(cache_root, "train_cache")]
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    whole = train.main([*common, "--epochs", str(n // k), "--ckpt_dir",
                        os.path.join(root, "whole")])
    train.main([*common, "--epochs", "1", "--ckpt_dir", os.path.join(root, "parts")])
    resumed = train.main([*common, "--epochs", str(n // k - 1), "--ckpt_dir",
                          os.path.join(root, "parts"), "--resume"])
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    counts = read_counts()
    diff = _snap_diff(_snapshot(resumed), _snapshot(whole))
    log(f"  (e) train_torch.py --dataset kitti, stage 1, fp32, B={b}: {n} steps unbroken vs "
        f"{k} + checkpoint + --resume {n - k}: max|d| {diff}; launches {counts_text(counts)} "
        f"({time.perf_counter() - t0:.1f} s)")
    if any(diff.values()) or resumed.step != n:
        raise AssertionError(f"resumed from disk at step {resumed.step}: {diff}")
    return counts, {"max_diff": diff}


def _split_vs_cpu(cfg, forward, samples):
    """The card's per-image metric columns against the CPU protocol on
    the same fp32 predictions, the first batch of each GT size: rtol and
    atol 1e-5 on the continuous metrics, a1-a3 within one pixel."""
    from gdn_tpu_torch import metrics as M
    from gdn_tpu_torch.evaluate import _batch_iter, _wire_encoders, make_eval_step

    worst, seen = {}, set()
    for shape, rgb, gt, n_real, _ in _batch_iter(samples, DISK_EVAL_BATCH, None,
                                                  *_wire_encoders(cfg)):
        if shape in seen:
            continue
        seen.add(shape)
        card = make_eval_step(cfg, forward, shape, return_preds=True, device="cuda")
        cpu = make_eval_step(cfg, lambda p: p, shape, device="cpu")
        cols, preds = card(rgb.cuda(), gt.cuda())
        want = cpu(preds.cpu()[..., None], gt).numpy()
        got = cols.cpu().numpy()
        valid = ((gt > cfg.model.min_depth) & (gt < cfg.eval.cap)
                 & torch.from_numpy(M.crop_mask(*shape, cfg.eval.crop))).sum(dim=(1, 2))
        for j, name in enumerate(M.METRIC_NAMES):
            if name in ("a1", "a2", "a3"):
                pixel = 1.0 / valid.clamp_min(1).numpy()
                if (np.abs(got[j] - want[j]) > pixel + 1e-6).any():
                    raise AssertionError(f"{shape} {name}: more than one pixel apart")
            else:
                np.testing.assert_allclose(got[j], want[j], atol=1e-5, rtol=1e-5,
                                           err_msg=f"{shape} {name}")
        worst[f"{shape[0]}x{shape[1]}"] = float(np.abs(got - want).max())
    return worst


def disk_eval(cfg, cfg_fused, kitti, cache_root, n_gn):
    """Phase 22 (f): eval from disk on the 64-image list (four raw sizes,
    PNG and velodyne GT), the card against the CPU protocol, and a fused
    stage-2 run with in-training eval over the list."""
    from gdn_tpu_torch import metrics as M
    from gdn_tpu_torch.checkpoint import load_params
    from gdn_tpu_torch.config import _with
    from gdn_tpu_torch.data.kitti import KittiEvalDataset
    from gdn_tpu_torch.evaluate import Evaluator
    from gdn_tpu_torch.models import RtoDNet
    from gdn_tpu_torch.train.steps import make_eval_forward

    calib = os.path.join(kitti, "calib")
    ckpt = os.path.join(OUT, "disk_host_fed")
    c = _with(cfg, **{"eval.batch_size": DISK_EVAL_BATCH, "eval.crop": "garg",
                      "eval.cap": 80.0, "data.data_path": kitti, "data.val_list": "eval.txt",
                      "data.calib_dir": calib})
    split = KittiEvalDataset(kitti, "eval.txt", c.model.image_size, calib_dir=calib)
    t0 = time.perf_counter()
    samples = list(split)
    read_s = time.perf_counter() - t0
    shapes = sorted({s["gt"].shape[1:] for s in samples})
    velo = [s["gt"] for s, e in zip(samples, split.entries) if e[1].endswith(".bin")]
    velo_px = float(np.mean([(g > 0).mean() for g in velo]))
    log(f"  (f) eval list read: {len(samples)} images, GT sizes {shapes}, {len(velo)} "
        f"velodyne GT ({velo_px:.2%} of pixels valid), in {read_s:.2f} s "
        f"({len(samples) / read_s:.1f} images/s host decode and projection)")
    net = RtoDNet(c.model)
    net.load_state_dict(load_params(os.path.join(ckpt, "stage2")))
    fwd = make_eval_forward(c, net.cuda())
    out, launches = {"read_images_per_s": len(samples) / read_s}, {}
    # passes compared bit for bit run cuDNN's deterministic algorithms
    torch.backends.cudnn.deterministic = True
    ev = Evaluator(c, fwd)
    torch.cuda.synchronize()
    reset_counts()
    direct = ev.run(split, verbose=False)
    torch.cuda.synchronize()
    launches["disk_eval_direct"] = counts = read_counts()
    batches = len(DISK_EVAL_SIZES) * -(-DISK_EVAL_PER_SIZE // DISK_EVAL_BATCH)
    forwards = batches + len(DISK_EVAL_SIZES)  # a warm-up batch a size
    expect_counts("eval from disk", counts, group_norm_elu=n_gn * forwards)
    out["warm_seconds"] = {f"{h}x{w}": s for (h, w), s in ev.warm_seconds.items()}
    out["protocol_err"] = _split_vs_cpu(c, fwd, samples)
    del ev
    script = load_script("eval_torch")
    args = ["--dataset", "kitti", "--data_path", kitti, "--val_list", "eval.txt",
            "--calib_dir", calib, "--ckpt_dir", ckpt, "--eval_batch", str(DISK_EVAL_BATCH)]
    for feed, extra in (("host_fed", []), ("device_cache", ["--device_cache"])):
        torch.cuda.synchronize()
        reset_counts()
        res = script.main(args + extra)
        torch.cuda.synchronize()
        launches[f"disk_eval_{feed}"] = counts = read_counts()
        expect_counts(f"eval_torch.py {feed}", counts, group_norm_elu=n_gn * forwards)
        if not all(np.isfinite(res[k]) for k in M.METRIC_NAMES):
            raise AssertionError(f"eval_torch.py {feed}: {res}")
        if any(res[k] != direct[k] for k in M.METRIC_NAMES):
            raise AssertionError(f"eval_torch.py {feed} {res} vs the direct pass {direct}")
        out[feed] = res
    torch.backends.cudnn.deterministic = False
    log(f"  (f) eval_torch.py --dataset kitti --calib_dir, {len(samples)} images, batch "
        f"{DISK_EVAL_BATCH}: rmse {out['host_fed']['rmse']:.4f}, a1 {out['host_fed']['a1']:.4f};"
        f" host-fed {out['host_fed']['fps']:.1f} images/s, --device_cache "
        f"{out['device_cache']['fps']:.1f} images/s (metrics equal to a direct pass); warm-up "
        "batch a GT size: " + ", ".join(f"{k} {v * 1e3:.0f} ms"
                                         for k, v in out["warm_seconds"].items())
        + "; card vs CPU protocol max|d| by size " + ", ".join(
            f"{k} {v:.3g}" for k, v in out["protocol_err"].items())
        + " (rtol/atol 1e-5, a1-a3 within one pixel)")
    # the fused configuration, disk-fed, with in-training eval over the list
    root = os.path.join(OUT, "disk_fused")
    shutil.rmtree(root, ignore_errors=True)
    flags = [f"--{k}" for k in FUSED]
    train = load_script("train_torch")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    state = train.main(["--mode", "RtoD", "--dataset", "kitti", "--data_path", kitti,
                        "--val_list", "eval.txt", "--calib_dir", calib, "--stage1_ckpt",
                        os.path.join(ckpt, "stage1"), "--ckpt_dir", root, "--epochs", "1",
                        "--steps_per_epoch", str(DISK_FUSED_STEPS), "--log_every",
                        str(DISK_FUSED_STEPS), "--eval_every", "1", "--eval_batch",
                        str(DISK_EVAL_PER_SIZE), "--decode_cache",
                        os.path.join(cache_root, "train_cache"), *flags])
    torch.cuda.synchronize()
    launches["disk_fused_train_eval"] = counts = read_counts()
    fused = {"group_norm_elu": 6, "conv_gn_elu_bt": 5, "conv_gn_elu_s2": 5, "fusion_bt": 5}
    eval_fwd = 2 * len(DISK_EVAL_SIZES)  # one batch and one warm-up a size
    expect_counts("fused stage 2 from disk with in-training eval", counts,
                  fused_loss_fwd=DISK_FUSED_STEPS, fused_loss_bwd=DISK_FUSED_STEPS,
                  **{k: v * (2 * DISK_FUSED_STEPS + eval_fwd) for k, v in fused.items()})
    recs = [json.loads(line) for line in open(os.path.join(root, "train_log.jsonl"))]
    rmse = [r["eval_rmse"] for r in recs if "eval_rmse" in r]
    if state.step != DISK_FUSED_STEPS or len(rmse) != 1 or not np.isfinite(rmse[0]):
        raise AssertionError(f"fused stage 2 from disk: step {state.step}, eval_rmse {rmse}")
    out["fused_train"] = {"eval_rmse": rmse[0], "launches": counts,
                          "seconds": time.perf_counter() - t0}
    log(f"  (f) fused stage 2 (rows 5-7) from disk, {DISK_FUSED_STEPS} steps with in-training "
        f"eval over the list: eval_rmse {rmse[0]:.4f}; launches {counts_text(counts)} "
        f"({out['fused_train']['seconds']:.1f} s)")
    return out, launches


def disk_nyu(nyu, n_gn):
    """Phase 22 (g): stage 1 on NYU at 228x304 (B=32, bf16) from disk,
    then the D-net's eval on the test frames (GT cropped to 426x560)."""
    from gdn_tpu_torch import metrics as M

    root = os.path.join(OUT, "disk_nyu")
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    state = load_script("train_torch").main([
        "--mode", "DtoD", "--dataset", "nyu", "--data_path", nyu, "--epochs", "1",
        "--steps_per_epoch", str(NYU_STEPS), "--log_every", str(NYU_STEPS), "--ckpt_dir", root,
        "--batch_size", str(TRAIN_BATCH)])
    res = load_script("eval_torch").main([
        "--dataset", "nyu", "--data_path", nyu, "--val_list", "test.txt", "--stage", "1",
        "--ckpt_dir", root, "--eval_batch", str(DISK_EVAL_BATCH)])
    torch.cuda.synchronize()
    counts = read_counts()
    forwards = NYU_TEST // DISK_EVAL_BATCH + 1
    expect_counts("NYU from disk", counts, fused_loss_fwd=NYU_STEPS, fused_loss_bwd=NYU_STEPS,
                  group_norm_elu=n_gn * (NYU_STEPS + forwards))
    recs = [json.loads(line) for line in open(os.path.join(root, "train_log.jsonl"))]
    if state.step != NYU_STEPS or not np.isfinite(recs[-1]["total"]) or not all(
            np.isfinite(res[k]) for k in M.METRIC_NAMES):
        raise AssertionError(f"NYU: step {state.step}, {recs[-1]}, eval {res}")
    log(f"  (g) NYU stage 1, 228x304, B={TRAIN_BATCH}: {NYU_STEPS} steps, total "
        f"{recs[-1]['total']:.4f}, {recs[-1]['imgs_per_sec']:.1f} images/s; D-net eval on "
        f"{NYU_TEST} frames (GT 426x560, cap 10): rmse {res['rmse']:.4f}, a1 {res['a1']:.4f}; "
        f"launches {counts_text(counts)} ({time.perf_counter() - t0:.1f} s)")
    return counts, {"train": recs[-1], "eval": res}


def phase_disk(cfg, cfg_fused, synthetic):
    """Phase 22: training and eval from disk (see the module docstring)."""
    root = os.path.join(OUT, "disk")
    n_gn = len(gn_sites(cfg.model))
    t0 = time.perf_counter()
    out, launches = {"device": smi_line()}, {}
    kitti, nyu, out["corpus_seconds"] = write_disk_corpus(root)
    out["decode"] = disk_decode(kitti, root)
    out["train"], train_launches = disk_train(cfg, kitti, root, synthetic, n_gn)
    launches.update(train_launches)
    out["vs_cpu"] = disk_vs_cpu(cfg, kitti)
    launches["disk_resume"], out["resume"] = disk_resume(kitti, root)
    out["eval"], eval_launches = disk_eval(cfg, cfg_fused, kitti, root, n_gn)
    launches.update(eval_launches)
    launches["disk_nyu"], out["nyu"] = disk_nyu(nyu, n_gn)
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 22 took {out['seconds']:.1f} s")
    return out, launches


TOOLS_WORKERS = (0, 2, 4, 8)  # (a): decode threads of the grain loader's counterpart
TOOLS_DECODE_BATCHES = 6
TOOLS_ORDER_BATCHES = 6
# (a): the record indices of the first TOOLS_ORDER_BATCHES batches of the
# 512-pair corpus at B=32, seed 0, as grain's own IndexSampler and Batch
# order them (grain's compiled index_shuffle, computed with grain 0.2.15):
# the first 16 hex digits of the sha256 of the int64 (6, 32) array, and
# the first batch's first 8 records
GRAIN_ORDER = {0: ("b2eb66bc1bfe514c", [134, 133, 395, 287, 149, 69, 95, 9]),
               4: ("dca7c5ae784a5ab4", [134, 149, 511, 254, 319, 364, 71, 70])}
TOOLS_CLI_STEPS = 6  # (b): a stage, cosine after a 4-step warmup
TOOLS_GUARD_STEPS = 8
TOOLS_DEMO_IMAGES = 4
# (c): a1_mean of the 600-step protocol (seeds 0 1 2, bf16, 300 steps a
# stage, 32x64, B=16, 30 eval images) on a CPU: the port's own
# scripts/convergence_torch.py --device cpu, and the JAX package's
# scripts/convergence.py --platform cpu.  The card's a1_mean is held to
# both within CONVERGENCE_A1_TOL: training draws its batches from another
# generator there and rounds otherwise, so it is not bit-equal.
PORT_CPU_CONVERGENCE_A1_MEAN = 0.8994
JAX_CONVERGENCE_A1_MEAN = 0.9054
CONVERGENCE_A1_TOL = 0.03
# (b): the fused routes by CLI flag, and one net's launches a forward;
# together they launch rows 4-9 of the kernels line
CLI_ROUTES = (
    ("plain", [], {"group_norm_elu": 21}),
    ("convgn", ["--model.use_pallas_convgn_s2", "--model.use_pallas_convgn",
                "--model.use_pallas_fusion_bt"],
     {"group_norm_elu": 6, "conv_gn_elu_s2": 5, "conv_gn_elu": 5, "fusion_bt": 5}),
    ("fusion", ["--model.use_pallas_convgn_bt", "--model.use_pallas_fusion"],
     {"group_norm_elu": 6, "conv_gn_elu_bt": 5, "upsample": 5, "fusion_block": 5}),
)


def _grain(kitti, workers, **kw):
    from gdn_tpu_torch.data.grain_loader import GrainKittiDataset

    return GrainKittiDataset(kitti, "train.txt", (128, 416), TRAIN_BATCH, seed=0,
                             worker_count=workers, **kw)


def tools_grain_decode(kitti, pil_rate):
    """Phase 23 (a): host decode images/s of the grain loader's
    counterpart at B=32, wire, for each thread count."""
    rates = {w: _decode_rate(_grain(kitti, w), TOOLS_DECODE_BATCHES) for w in TOOLS_WORKERS}
    best = max(rates, key=rates.get)
    log(f"  (a) grain counterpart, host decode at B={TRAIN_BATCH} over "
        f"{TOOLS_DECODE_BATCHES} batches, wire: " + ", ".join(
            f"{w} threads {r:.0f}" for w, r in rates.items())
        + f" images/s; phase 22 (b)'s one-thread PIL loader {pil_rate:.0f}; best {best}")
    return {"images_per_s": rates, "best_workers": best, "phase22_pil": pil_rate}


def tools_grain_order(cfg, kitti):
    """Phase 23 (a): at 0 and 4 threads the first batches hold grain's
    records (GRAIN_ORDER), a second loader yields the same host batches,
    and the card's wire decode of them equals the CPU's."""
    import hashlib

    from gdn_tpu_torch.config import _with
    from gdn_tpu_torch.data.augment import decode_wire_batch
    from gdn_tpu_torch.data.pipeline import host_tensor, make_train_pipeline

    c = _with(cfg, **{"data.batch_size": TRAIN_BATCH})
    out = {}
    for w in (0, 4):
        ld = _grain(kitti, w)
        k = max(w, 1)
        pos = [[j % k + k * ((j // k) * TRAIN_BATCH + t) for t in range(TRAIN_BATCH)]
               for j in range(TOOLS_ORDER_BATCHES)]
        recs = np.stack([ld.records(np.asarray(p)) for p in pos]).astype(np.int64)
        digest = hashlib.sha256(recs.tobytes()).hexdigest()[:16]
        if (digest, recs[0][:8].tolist()) != GRAIN_ORDER[w]:
            raise AssertionError(f"grain order at {w} threads: {digest} {recs[0][:8]} vs "
                                 f"{GRAIN_ORDER[w]}")
        host = [b for b, _ in zip(ld, range(TOOLS_ORDER_BATCHES))]
        again = [b for b, _ in zip(_grain(kitti, w), range(TOOLS_ORDER_BATCHES))]
        card = [{k2: v.cpu() for k2, v in b.items()} for b, _ in zip(
            make_train_pipeline(c, _grain(kitti, w), augment=False, device="cuda"),
            range(TOOLS_ORDER_BATCHES))]
        rgb_err = 0.0
        for h, a, g in zip(host, again, card):
            for key in h:
                if not np.array_equal(h[key], a[key]):
                    raise AssertionError(f"grain loader at {w} threads: {key} differs between "
                                         "two loaders")
            cpu = decode_wire_batch({k2: host_tensor(v) for k2, v in h.items()},
                                    max_depth=cfg.model.max_depth, depth_scale=256.0)
            for key in ("depth", "mask"):
                if not torch.equal(cpu[key], g[key]):
                    raise AssertionError(f"grain batch at {w} threads: {key} card != CPU")
            rgb_err = max(rgb_err, (cpu["rgb"] - g["rgb"]).abs().max().item())
        if rgb_err > 1e-6:
            raise AssertionError(f"grain batch at {w} threads: rgb card vs CPU {rgb_err}")
        out[w] = {"sha256_16": digest, "rgb_max_abs_err": rgb_err}
    log(f"  (a) the first {TOOLS_ORDER_BATCHES} batches at 0 and 4 threads hold grain's "
        f"records (sha256 {out[0]['sha256_16']}, {out[4]['sha256_16']}), two loaders yield "
        f"them bit for bit, and their wire decode on the card equals the CPU's (depth and "
        f"mask exact, RGB max|d| {max(o['rgb_max_abs_err'] for o in out.values()):.3g})")
    return out


def tools_grain_train(cfg, kitti, workers, n_gn, disk, profile=True):
    """Phase 23 (a): stage 1 then stage 2, unfused, B=32, bf16,
    DISK_STEPS each, host-fed through make_train_pipeline from the
    grain loader's counterpart at ``workers`` threads (with ``profile``,
    one profiled stage-2 step); phase 22 (c)'s host-fed and
    decode-cache rows of the same call beside it."""
    from gdn_tpu_torch.config import _with
    from gdn_tpu_torch.data.pipeline import make_train_pipeline
    from gdn_tpu_torch.train.loop import train_stage1, train_stage2
    from gdn_tpu_torch.utils.logging import MetricLogger

    c = _with(cfg, **{"train.steps_per_epoch": DISK_STEPS, "train.log_every": DISK_STEPS,
                      "train.ckpt_dir": "", "data.batch_size": TRAIN_BATCH,
                      "data.loader": "grain", "data.grain_workers": workers})
    pipe = make_train_pipeline(c, _grain(kitti, workers), device="cuda")
    row, launches = {"workers": workers}, {}
    for stage in ("stage1", "stage2"):
        jsonl = os.path.join(OUT, f"tools_grain_{stage}.jsonl")
        if os.path.exists(jsonl):
            os.remove(jsonl)
        logger = MetricLogger(prefix=stage, jsonl_path=jsonl, stream=io.StringIO())
        torch.cuda.synchronize()
        reset_counts()
        if stage == "stage1":
            d_net = train_stage1(c, pipe, epochs=1, logger=logger).net.requires_grad_(False)
        else:
            s2 = train_stage2(c, pipe, d_net, epochs=1, logger=logger)
        torch.cuda.synchronize()
        launches[f"tools_grain{workers}_{stage}"] = counts = read_counts()
        logger.close()
        nets = 1 if stage == "stage1" else 2
        expect_counts(f"grain {stage}", counts, fused_loss_fwd=DISK_STEPS,
                      fused_loss_bwd=DISK_STEPS, group_norm_elu=n_gn * nets * DISK_STEPS)
        rec = [json.loads(line) for line in open(jsonl)][-1]
        ips = rec["imgs_per_sec"]
        row[stage] = {"images_per_s": ips, "ms_per_step": 1e3 * TRAIN_BATCH / ips,
                      "total": rec["total"]}
    row["profile"] = profile_disk_step(c, s2, d_net, pipe, "tools_grain") if profile else None
    pipe.close()
    ref = {f: {s: disk["train"][f][s]["ms_per_step"] for s in ("stage1", "stage2")}
           for f in ("host_fed", "decode_cache")}
    pr = row["profile"] or {}
    log(f"  (a) grain counterpart, {workers} threads, host-fed: stage 1 "
        f"{row['stage1']['ms_per_step']:.1f} ms/step ({row['stage1']['images_per_s']:.1f} "
        f"images/s), stage 2 {row['stage2']['ms_per_step']:.1f} "
        f"({row['stage2']['images_per_s']:.1f}); phase 22 (c) host-fed "
        f"{ref['host_fed']['stage1']:.1f} / {ref['host_fed']['stage2']:.1f}, decode cache "
        f"{ref['decode_cache']['stage1']:.1f} / {ref['decode_cache']['stage2']:.1f} ms/step"
        + (f"; one stage-2 step: wall {pr.get('wall_ms', float('nan')):.1f} ms, device busy "
           f"{pr.get('device_busy_ms', float('nan')):.2f} ms (idle "
           f"{pr.get('idle_share', float('nan')):.1%}), {pr.get('kernel_launches')} launches"
           if profile else ""))
    row["phase22_ms_per_step"] = ref
    return row, launches


def tools_grain_resume(kitti):
    """Phase 23 (a): scripts/train_torch.py --loader grain --workers 4,
    stage 1, fp32, B=8: 6 steps unbroken against 3, a checkpoint with
    the grain cursor and --resume for 3; bit for bit under cuDNN's
    deterministic algorithms (phase 21 (a)'s rule)."""
    from gdn_tpu_torch.checkpoint import load_loader_state

    n, k, b = DISK_RESUME
    root = os.path.join(OUT, "tools_grain_resume")
    shutil.rmtree(root, ignore_errors=True)
    train = load_script("train_torch")
    common = ["--mode", "DtoD", "--dataset", "kitti", "--data_path", kitti, "--loader",
              "grain", "--workers", "4", "--dtype", "float32", "--batch_size", str(b),
              "--steps_per_epoch", str(k), "--log_every", str(k)]
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    try:
        whole = train.main([*common, "--epochs", str(n // k), "--ckpt_dir",
                            os.path.join(root, "whole")])
        train.main([*common, "--epochs", "1", "--ckpt_dir", os.path.join(root, "parts")])
        entry = load_loader_state(os.path.join(root, "parts", "stage1"))
        resumed = train.main([*common, "--epochs", str(n // k - 1), "--ckpt_dir",
                              os.path.join(root, "parts"), "--resume"])
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    counts = read_counts()
    diff = _snap_diff(_snapshot(resumed), _snapshot(whole))
    log(f"  (a) train_torch.py --loader grain --workers 4, stage 1, fp32, B={b}: {n} steps "
        f"unbroken vs {k} + checkpoint (loader entry {entry}) + --resume {n - k}: max|d| "
        f"{diff} ({time.perf_counter() - t0:.1f} s)")
    if any(diff.values()) or resumed.step != n or "grain" not in entry:
        raise AssertionError(f"grain resume at step {resumed.step}: {diff}, {entry}")
    return counts, {"max_diff": diff, "loader_entry": entry}


def _cosine_warmup(lr, t, warmup, total):
    """optax's linear warmup then cosine decay to 0, the LR of update t."""
    if t < warmup:
        return lr * t / warmup
    return lr * 0.5 * (1 + np.cos(np.pi * min(t - warmup, total - warmup) / (total - warmup)))


def tools_cli(n_gn):
    """Phase 23 (b): scripts/train_torch.py with the JAX flags, stage 1
    then stage 2, once a fused route (CLI_ROUTES): launches exact, the
    logged learning rates against the schedule's formula, TensorBoard."""
    import glob
    import importlib.util

    train = load_script("train_torch")
    steps, warmup, lr = TOOLS_CLI_STEPS, 4, 1e-4
    common = ["--dataset", "synthetic", "--lr_schedule", "cosine", "--warmup_steps",
              str(warmup), "--grad_clip", "1.0", "--tensorboard", "--epochs", "1",
              "--steps_per_epoch", str(steps), "--log_every", "1", "--lr", str(lr)]
    want_lr = [_cosine_warmup(lr, t, warmup, steps) for t in range(steps)]
    has_tb = importlib.util.find_spec("tensorboard") is not None
    out, launches = {"tensorboard_installed": has_tb}, {}
    for tag, flags, per_net in CLI_ROUTES:
        per_net = dict(per_net, group_norm_elu=per_net["group_norm_elu"] - 21 + n_gn)
        model_dir = os.path.join(OUT, f"tools_cli_{tag}")
        shutil.rmtree(model_dir, ignore_errors=True)
        row = {}
        for mode, nets in (("DtoD", 1), ("RtoD", 2)):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            train.main(["--mode", mode, *common, *flags, "--model_dir", model_dir])
            torch.cuda.synchronize()
            row[f"{mode}_s"] = time.perf_counter() - t0
            launches[f"tools_cli_{tag}_{mode}"] = counts = read_counts()
            expect_counts(f"train_torch.py {tag} {mode}", counts, fused_loss_fwd=steps,
                          fused_loss_bwd=steps,
                          **{k: v * nets * steps for k, v in per_net.items()})
        recs = [json.loads(line) for line in open(os.path.join(model_dir, "train_log.jsonl"))]
        got = [[r["lr"] for r in recs if "lr" in r][s * steps:(s + 1) * steps] for s in (0, 1)]
        err = max(abs(g - w) for stage in got for g, w in zip(stage, want_lr))
        if len(got[1]) != steps or err > 1e-12 * lr:
            raise AssertionError(f"{tag}: logged LRs {got} vs the formula {want_lr}")
        events = glob.glob(os.path.join(model_dir, "tb", "events.out.tfevents*"))
        if has_tb and not events:
            raise AssertionError(f"{tag}: no TensorBoard events under {model_dir}/tb")
        row.update(lr_max_abs_err=err, tb_event_files=len(events))
        out[tag] = row
        log(f"  (b) train_torch.py {' '.join(flags) or '(unfused)'} --lr_schedule cosine "
            f"--warmup_steps {warmup} --grad_clip 1.0 --tensorboard: {steps} steps a stage, "
            f"launches exact ({counts_text(counts)} in stage 2); logged LRs "
            f"{[f'{v:.3g}' for v in got[0]]} = formula within {err:.2g}; "
            + (f"{len(events)} TensorBoard event files" if has_tb else
               "no tensorboard package: the logger printed its warning, JSONL written")
            + f" ({row['DtoD_s']:.1f} + {row['RtoD_s']:.1f} s)")
    out["lr_formula"] = want_lr
    return out, launches


def tools_guard(cfg, n_gn):
    """Phase 23 (b): train_stage1 with check_numerics (GuardedStep: a
    device-to-host read of the loss terms every step) against without,
    alternated, ms/step of each (host clock over steps 2-N)."""
    from gdn_tpu_torch.config import _with
    from gdn_tpu_torch.data.synthetic import SyntheticDataset
    from gdn_tpu_torch.train.loop import train_stage1
    from gdn_tpu_torch.utils.logging import MetricLogger

    h, w = cfg.model.image_size
    out, launches = {"guarded": [], "unguarded": []}, {}
    for i, guard in enumerate((False, True, False, True)):
        c = _with(cfg, **{"train.steps_per_epoch": TOOLS_GUARD_STEPS,
                          "train.log_every": TOOLS_GUARD_STEPS, "train.ckpt_dir": "",
                          "data.batch_size": TRAIN_BATCH, "train.check_numerics": guard})
        jsonl = os.path.join(OUT, "tools_guard.jsonl")
        if os.path.exists(jsonl):
            os.remove(jsonl)
        logger = MetricLogger(prefix="guard", jsonl_path=jsonl, stream=io.StringIO())
        reset_counts()
        train_stage1(c, SyntheticDataset(TRAIN_BATCH, h, w, cfg.model.max_depth, seed=i,
                                         device="cuda"), epochs=1, logger=logger)
        torch.cuda.synchronize()
        logger.close()
        launches[f"tools_guard_{i}"] = counts = read_counts()
        expect_counts("guard", counts, fused_loss_fwd=TOOLS_GUARD_STEPS,
                      fused_loss_bwd=TOOLS_GUARD_STEPS,
                      group_norm_elu=n_gn * TOOLS_GUARD_STEPS)
        rec = [json.loads(line) for line in open(jsonl)][-1]
        out["guarded" if guard else "unguarded"].append(1e3 * TRAIN_BATCH / rec["imgs_per_sec"])
    log(f"  (b) GuardedStep (check_numerics), stage 1, B={TRAIN_BATCH}, {TOOLS_GUARD_STEPS} "
        f"steps, alternated: guarded {', '.join(f'{v:.1f}' for v in out['guarded'])} ms/step, "
        f"unguarded {', '.join(f'{v:.1f}' for v in out['unguarded'])}")
    return out, launches


def tools_convergence():
    """Phase 23 (c): scripts/convergence_torch.py --seeds 0 1 2 (300 steps
    a stage, 32x64, B=16, bf16)."""
    t0 = time.perf_counter()
    reset_counts()
    done = load_script("convergence_torch").main(["--seeds", "0", "1", "2"])
    counts = read_counts()
    minutes = (time.perf_counter() - t0) / 60
    for seed, m in done["per_seed"].items():
        log(f"  (c) seed {seed}: " + " ".join(f"{k}={v:.4f}" for k, v in m.items()))
    a1 = done["a1_mean"]
    refs = {"port_cpu": PORT_CPU_CONVERGENCE_A1_MEAN, "jax_cpu": JAX_CONVERGENCE_A1_MEAN}
    log(f"  (c) convergence_torch.py --seeds 0 1 2: a1_mean {a1:.4f} in {minutes:.2f} min; "
        f"on a CPU the port's {PORT_CPU_CONVERGENCE_A1_MEAN} (difference "
        f"{a1 - PORT_CPU_CONVERGENCE_A1_MEAN:+.4f}), the JAX package's "
        f"{JAX_CONVERGENCE_A1_MEAN} (difference {a1 - JAX_CONVERGENCE_A1_MEAN:+.4f}), "
        f"bound {CONVERGENCE_A1_TOL}")
    far = {k: v for k, v in refs.items() if not abs(a1 - v) <= CONVERGENCE_A1_TOL}
    if far:
        raise AssertionError(f"convergence protocol: a1_mean {a1} further than "
                             f"{CONVERGENCE_A1_TOL} from {far}")
    return {"done": done, "minutes": minutes, "a1_mean_on_cpu": refs,
            "a1_tol": CONVERGENCE_A1_TOL}, counts


def tools_scripts(kitti, training, cli_dir):
    """Phase 23 (d): profile_step_torch.py, bench_torch.py,
    bench_eval_torch.py --device_cache and demo_torch.py, once each,
    in this process (each main() must return)."""
    from PIL import Image

    out, launches = {}, {}
    reset_counts()
    prof = load_script("profile_step_torch").main([
        "--mode", "RtoD", "--steps", "3", "--batch_size", str(TRAIN_BATCH),
        "--logdir", os.path.join(OUT, "tools_profile")])
    launches["tools_profile_step"] = read_counts()
    p8 = training.get("profile") or {}
    out["profile_step"] = prof
    log(f"  (d) profile_step_torch.py --mode RtoD --steps 3 --batch_size {TRAIN_BATCH}: "
        f"device {prof['device_ms_per_step']:.2f} ms a step, wall "
        f"{prof['wall_ms_per_step']:.1f}, idle {prof['idle_share']:.1%}, "
        f"{prof['launches_per_step']:.1f} launches; phase 8's profiled step: device "
        f"{p8.get('device_busy_ms', float('nan')):.2f} ms, idle "
        f"{p8.get('idle_share', float('nan')):.1%}, {p8.get('kernel_launches')} launches")
    for name, ms, calls in prof["top_kernels"][:6]:
        log(f"    {ms:8.3f} ms  x{calls:<6.1f} {name[:90]}")
    reset_counts()
    out["bench"] = load_script("bench_torch").main([])
    launches["tools_bench"] = read_counts()
    b = out["bench"]
    log(f"  (d) bench_torch.py: median {b['value']:.1f} images/s over {len(b['calls'])} "
        f"calls ({', '.join(f'{v:.1f}' for v in b['calls'])}; spread {b['spread']:.1%}), SM "
        f"clock {b['sm_clock_mhz']} MHz, load {[round(v, 2) for v in b['load_avg_1m']]}")
    reset_counts()
    out["bench_eval"] = load_script("bench_eval_torch").main(["--device_cache"])
    launches["tools_bench_eval"] = read_counts()
    log("  (d) bench_eval_torch.py --device_cache: " + "; ".join(
        f"pass {r['pass']} {r['fps']:.1f} images/s" for r in out["bench_eval"])
        + f" ({out['bench_eval'][0]['images']} images, batch {out['bench_eval'][0]['batch']}, "
        f"cache {out['bench_eval'][0]['cache_mb']:.0f} MiB built in "
        f"{out['bench_eval'][0]['cache_build_s']:.2f} s)")
    src = os.path.join(OUT, "tools_demo_in")
    dst = os.path.join(OUT, "tools_demo_out")
    for d in (src, dst):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(src)
    names = sorted(n for n in os.listdir(os.path.join(kitti, "eval")) if n.endswith(".png")
                   and "_gt" not in n)[::DISK_EVAL_PER_SIZE][:TOOLS_DEMO_IMAGES]
    for n in names:
        shutil.copy(os.path.join(kitti, "eval", n), os.path.join(src, n))
    reset_counts()
    written = load_script("demo_torch").main(["--input", src, "--output", dst, "--gif",
                                              "demo.gif", "--model_dir", cli_dir])
    launches["tools_demo"] = read_counts()
    sizes = []
    for n, path in zip(names, written):
        hw = Image.open(os.path.join(src, n)).size[::-1]
        got = Image.open(path).size[::-1]
        sizes.append((hw, got))
        if got != (2 * hw[0], hw[1]):
            raise AssertionError(f"demo: {path} is {got}, its input {hw}")
    if len(written) != len(names) + 1 or not written[-1].endswith("demo.gif"):
        raise AssertionError(f"demo wrote {written}")
    out["demo"] = {"written": len(written), "sizes": sizes}
    log(f"  (d) demo_torch.py on {len(names)} eval images ({', '.join(f'{h}x{w}' for (h, w), _ in sizes)}): "
        f"{len(names)} maps at each input's size (frame above depth) and a GIF")
    return out, launches


def phase_tools(cfg, disk, training):
    """Phase 23: the grain loader's counterpart, the command line, the
    guard, the convergence protocol and the tools (see the module
    docstring)."""
    kitti = os.path.join(OUT, "disk", "kitti")
    n_gn = len(gn_sites(cfg.model))
    t0 = time.perf_counter()
    out, launches = {"device": smi_line()}, {}
    out["decode"] = tools_grain_decode(kitti, disk["decode"]["pil"]["auto_cold"])
    out["order"] = tools_grain_order(cfg, kitti)
    best = out["decode"]["best_workers"]
    out["train"] = {}
    for w in sorted({0, 2, best}):  # the profile at the best count only
        out["train"][w], more = tools_grain_train(cfg, kitti, w, n_gn, disk,
                                                  profile=w == best)
        launches.update(more)
    launches["tools_grain_resume"], out["resume"] = tools_grain_resume(kitti)
    out["cli"], more = tools_cli(n_gn)
    launches.update(more)
    out["guard"], more = tools_guard(cfg, n_gn)
    launches.update(more)
    out["convergence"], launches["tools_convergence"] = tools_convergence()
    out["scripts"], more = tools_scripts(kitti, training, os.path.join(OUT, "tools_cli_plain"))
    launches.update(more)
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 23 took {out['seconds']:.1f} s")
    return out, launches


ART_IMAGES = 20  # phase 24: images served through every artifact
ART_CONFIGS = ("unfused", "all", "fusion", "v1")  # together rows 1 and 4-9
QUANT_CALIB = (2, 4)  # (b): synthetic calibration batches x images, card and CPU
QUANT_SCALE_TOL = 0.01  # (b): card vs CPU scales in fp32, relative
# (b): the same in bf16: a scale is the absmax of bf16 GN+ELU outputs,
# which phase 3 holds to the plain version at rtol 0.05 (TOL)
QUANT_SCALE_TOL_BF16 = TOL[torch.bfloat16][0]
INT8_CPU_IMAGES = 2  # (b): images of the CPU int8 run
INT8_VS_BF16 = 0.05  # (b): relative mean |d| of int8 against bf16 (tests/test_quant.py)
TRAIN_CALIB_BATCHES = 4  # (c): train_split_calibration_batches' default
# (a): a fresh process with only torch, the kernels and serving: every
# artifact through from_artifact, both wires, launches a batch by kernel
ART_LOADER = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.deterministic = True
import chip_smoke as S
from gdn_tpu_torch.serving import BatchedPredictor
images = np.load(sys.argv[2])
sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
depths, info = {}, {}
for name, path in json.loads(sys.argv[4]).items():
    t0 = time.perf_counter()
    pred = BatchedPredictor.from_artifact(path)
    load_s = time.perf_counter() - t0
    pred.predict(images[:pred.batch_size])
    sync()
    S.reset_counts()
    depths[name + "_f32"] = pred.predict(images)
    sync()
    counts = S.read_counts()
    depths[name + "_u16"] = pred.predict(images, wire="u16")
    info[name] = {"load_s": load_s, "counts": counts, "batch": pred.batch_size,
                  "image_size": list(pred.image_size)}
np.savez(sys.argv[3], **depths)
print(json.dumps({"info": info,
                  "port_modules": sorted(m for m in sys.modules if m.startswith("gdn_tpu"))}))
"""


def _eager(cfg, sd, images, scales=None):
    """A checkpoint predictor's depths on both wires and its launches a
    batch (f32 wire), after a warm-up batch."""
    from gdn_tpu_torch.serving import BatchedPredictor

    pred = BatchedPredictor(cfg, sd, batch_size=BATCH, quant_scales=scales)
    pred.predict(images[:BATCH])
    torch.cuda.synchronize()
    reset_counts()
    f32 = pred.predict(images)
    torch.cuda.synchronize()
    counts = read_counts()
    return pred, f32, pred.predict(images, wire="u16"), counts


def _per_batch(counts, batches):
    return {k: v // batches for k, v in counts.items() if v}


def art_int8_scales(cfg_int8, sd):
    """Phase 24 (b): the int8 scales calibrated on the card and on the
    CPU on the same synthetic batches (a CPU generator's draws): in fp32,
    where the two compute one function up to summation order, within
    QUANT_SCALE_TOL (what is left is one-step int8 flips carried
    downstream); in bf16, the serving dtype, within QUANT_SCALE_TOL_BF16.
    Returns the card's scales by dtype."""
    from gdn_tpu_torch.config import _with
    from gdn_tpu_torch.ops.quant import (
        quantized_model_and_scales, synthetic_calibration_batches,
    )

    batches = list(synthetic_calibration_batches(cfg_int8, *QUANT_CALIB))
    out, scales = {}, {}
    torch.cuda.synchronize()
    reset_counts()
    for dtype, tol in (("float32", QUANT_SCALE_TOL), ("bfloat16", QUANT_SCALE_TOL_BF16)):
        c = _with(cfg_int8, **{"model.dtype": dtype})
        t0 = time.perf_counter()
        card = quantized_model_and_scales(c, sd, calib_batches=batches)[1]
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = quantized_model_and_scales(c, sd, calib_batches=batches, device="cpu")[1]
        cpu_s = time.perf_counter() - t0
        rel = {k: abs(card[k].item() / cpu[k].item() - 1) for k in card}
        worst = max(rel, key=rel.get)
        log(f"  (b) int8 scales at {len(card)} sites, {dtype}, calibrated on "
            f"{QUANT_CALIB[0]} x {QUANT_CALIB[1]} synthetic images: card {card_s:.2f} s, "
            f"CPU {cpu_s:.2f} s; card vs CPU max rel {rel[worst]:.3g} ({worst}), mean "
            f"{np.mean(list(rel.values())):.3g} (bound {tol})")
        if set(card) != set(cpu) or rel[worst] > tol:
            raise AssertionError(f"int8 scales ({dtype}) card vs CPU beyond {tol}: {rel}")
        out[dtype] = {"sites": len(card), "card_vs_cpu_max_rel": rel[worst],
                      "card_vs_cpu_mean_rel": float(np.mean(list(rel.values()))),
                      "card_s": card_s, "cpu_s": cpu_s}
        scales[dtype] = card
    torch.cuda.synchronize()
    counts = read_counts()
    expect_counts("int8 calibration", counts,
                  group_norm_elu=2 * len(gn_sites(cfg_int8.model)) * QUANT_CALIB[0])
    return scales, counts, out


def art_int8_sites(cfg, sd, scales, images):
    """Phase 24 (b): the CPU int8 forward of ``images`` -> its depth, with
    every int8 site's input recorded; each site's conv then runs on the
    card on that same input: int32 sums exact, output within rtol 1e-6
    (the same IEEE operations)."""
    from gdn_tpu_torch.models import blocks
    from gdn_tpu_torch.ops import quant as Q
    from gdn_tpu_torch.serving import BatchedPredictor

    seen = []
    conv = blocks._conv_int8

    def record(block, x, kernel, stride):
        seen.append((x.detach().clone(), kernel.detach(), stride, block.x_scale.clone()))
        return conv(block, x, kernel, stride)

    blocks._conv_int8 = record
    try:
        depth = BatchedPredictor(cfg, sd, batch_size=len(images), device="cpu",
                                 quant_scales=scales).predict(images)
    finally:
        blocks._conv_int8 = conv
    worst = 0.0
    for x, k, stride, sc in seen:
        sums = [Q.conv2d_s32(Q.quantize_act(v.permute(0, 2, 3, 1), t),
                             Q.quantize_weight_per_channel(w)[0], stride).cpu()
                for v, w, t in ((x, k, sc), (x.cuda(), k.cuda(), sc.cuda()))]
        if not torch.equal(*sums):
            raise AssertionError(f"int8 sums card vs CPU at a site of {tuple(x.shape)}")
        want = Q.conv2d_int8(x, k, stride, sc)
        got = Q.conv2d_int8(x.cuda(), k.cuda(), stride, sc.cuda()).cpu()
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
        worst = max(worst, ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item())
    return depth, len(seen), worst


def art_timing(preds, images):
    """Phase 24 (b): ms a batch (host clock, best of 3 calls of 64
    images) and a profiled call of each predictor, in turns."""
    many = np.concatenate([images] * 4)[:64]
    out = {}
    for name, pred in preds.items():
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            pred.predict(many)
            times.append(time.perf_counter() - t0)
        out[name] = {"ms_per_batch": 1e3 * min(times) / (len(many) // BATCH),
                     "images_per_s": len(many) / min(times),
                     "profile": profile_serving(pred, many, f"serving_{name}_p24")}
        prof = out[name]["profile"] or {}
        log(f"  (b) {name}: {out[name]['ms_per_batch']:.2f} ms a batch of {BATCH} "
            f"({out[name]['images_per_s']:.1f} images/s); device busy "
            f"{prof.get('device_busy_ms', float('nan')):.2f} ms of 64 images, idle "
            f"{prof.get('idle_share', float('nan')):.1%}")
    return out


def art_eval_int8(n_gn, disk):
    """Phase 24 (c): scripts/eval_torch.py --quantize int8 on phase 22's
    eval list, its scales calibrated on the train list, beside phase 22
    (f)'s bf16 metrics of the same checkpoint."""
    from gdn_tpu_torch import metrics as M

    kitti = os.path.join(OUT, "disk", "kitti")
    args = ["--dataset", "kitti", "--data_path", kitti, "--val_list", "eval.txt",
            "--calib_dir", os.path.join(kitti, "calib"), "--ckpt_dir",
            os.path.join(OUT, "disk_host_fed"), "--eval_batch", str(DISK_EVAL_BATCH),
            "--quantize", "int8"]
    torch.cuda.synchronize()
    reset_counts()
    res = load_script("eval_torch").main(args)
    torch.cuda.synchronize()
    counts = read_counts()
    forwards = (len(DISK_EVAL_SIZES) * -(-DISK_EVAL_PER_SIZE // DISK_EVAL_BATCH)
                + len(DISK_EVAL_SIZES))  # a warm-up batch a GT size
    expect_counts("eval_torch.py --quantize int8", counts,
                  group_norm_elu=n_gn * (TRAIN_CALIB_BATCHES + forwards))
    if not all(np.isfinite(res[k]) for k in M.METRIC_NAMES):
        raise AssertionError(f"eval_torch.py --quantize int8: {res}")
    bf16 = disk["eval"]["host_fed"]
    log("  (c) eval_torch.py --quantize int8 (calibrated on the train list), int8 / bf16: "
        + ", ".join(f"{k} {res[k]:.4f} / {bf16[k]:.4f}" for k in M.METRIC_NAMES)
        + f"; {res['fps']:.1f} / {bf16['fps']:.1f} images/s; launches {counts_text(counts)}")
    return counts, {"int8": res, "bf16": bf16}


def art_serve(path):
    """Phase 24 (d): scripts/serve_torch.py --artifact answering one POST."""
    from PIL import Image

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "scripts", "serve_torch.py"), "--artifact", path,
         "--port", "0"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT)
    try:
        lines = []
        deadline = time.time() + 180
        while time.time() < deadline:
            lines.append(proc.stdout.readline())
            if "serving on" in lines[-1] or proc.poll() is not None:
                break
        if "serving on" not in lines[-1]:
            raise AssertionError("serve_torch.py --artifact did not start: " + "".join(lines))
        port = int(lines[-1].split("http://127.0.0.1:")[1].split(" ")[0])
        buf = io.BytesIO()
        Image.fromarray(np.random.default_rng(24).integers(0, 255, (128, 416, 3), np.uint8)
                        ).save(buf, format="PNG")
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            depth = np.load(io.BytesIO(r.read()))
        if depth.shape != (128, 416) or not np.isfinite(depth).all():
            raise AssertionError(f"serve_torch.py --artifact answered {depth.shape}")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    seconds = time.perf_counter() - t0
    said = next((ln.strip() for ln in lines if ln.startswith("artifact:")), "")
    log(f"  (d) serve_torch.py --artifact --port 0: answered one POST, depth {depth.shape}, "
        f"mean {depth.mean():.3f} m ({seconds:.1f} s with its start; {said})")
    return {"seconds": seconds, "mean_depth_m": float(depth.mean())}


def phase_artifacts(cfgs, per_net, sd, disk):
    """Phase 24: torch.export artifacts and int8 post-training
    quantization (see the module docstring).  ``cfgs`` and ``per_net``
    name the four configurations of (a) and their launches a net."""
    from gdn_tpu_torch.config import _with
    from gdn_tpu_torch.serving import BatchedPredictor, export_model

    root = os.path.join(OUT, "artifacts")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    # depths compared bit for bit across processes: deterministic cuDNN
    # algorithms here and in the loader
    torch.backends.cudnn.deterministic = True
    n_gn = len(gn_sites(cfgs["unfused"].model))
    t0 = time.perf_counter()
    out, launches = {"device": smi_line()}, {}
    h, w = cfgs["unfused"].model.image_size
    images = np.random.default_rng(24).integers(0, 256, (ART_IMAGES, h, w, 3), np.uint8)
    batches = -(-ART_IMAGES // BATCH)
    cfgs = {**cfgs, "int8": _with(cfgs["unfused"], **{"model.quant": "int8"})}
    per_net = {**per_net, "int8": {"group_norm_elu": n_gn}}
    by_dtype, launches["int8_calibration"], out["calibration"] = art_int8_scales(
        cfgs["int8"], sd)
    scales = by_dtype[cfgs["int8"].model.dtype]

    # (a) export on the card, then the checkpoint predictor of each config
    paths, eager, preds = {}, {}, {}
    for name, cfg in cfgs.items():
        paths[name] = os.path.join(root, f"{name}.pt2")
        q = scales if name == "int8" else None
        t1 = time.perf_counter()
        export_model(cfg, sd, paths[name], batch_size=BATCH, quant_scales=q)
        out[name] = {"export_s": time.perf_counter() - t1,
                     "mb": os.path.getsize(paths[name]) / 1e6}
        pred, f32, u16, counts = _eager(cfg, sd, images, q)
        eager[name] = (f32, u16)
        launches[f"artifact_eager_{name}"] = counts
        expect_counts(f"{name} predictor", counts,
                      **{k: v * batches for k, v in per_net[name].items()})
        if name in ("unfused", "int8"):
            preds[name] = pred
        log(f"  (a) {name}: exported in {out[name]['export_s']:.2f} s, "
            f"{out[name]['mb']:.1f} MB; predictor launches a batch "
            f"{_per_batch(counts, batches)}")
    np.save(os.path.join(root, "images.npy"), images)
    t1 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-c", ART_LOADER, ROOT, os.path.join(root, "images.npy"),
         os.path.join(root, "depths.npz"), json.dumps(paths)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    if run.returncode != 0:
        raise AssertionError(f"the artifact loader failed: {run.stderr[-4000:]}")
    loaded = json.loads(run.stdout.strip().splitlines()[-1])
    out["loader_s"] = time.perf_counter() - t1
    mods = loaded["port_modules"]
    log(f"  (a) a fresh process loaded {len(paths)} artifacts in {out['loader_s']:.1f} s; "
        f"port modules it imported: {mods}")
    if any(m.startswith("gdn_tpu_torch.models") for m in mods) or any(
            m == "gdn_tpu" or m.startswith("gdn_tpu.") for m in mods):
        raise AssertionError(f"the artifact loader imported {mods}")
    got = np.load(os.path.join(root, "depths.npz"))
    for name in cfgs:
        info = loaded["info"][name]
        launches[f"artifact_{name}"] = counts = info["counts"]
        want = launches[f"artifact_eager_{name}"]
        if counts != want or info["batch"] != BATCH or info["image_size"] != [h, w]:
            raise AssertionError(f"artifact {name}: {info} vs the predictor's launches {want}")
        f32, u16 = got[f"{name}_f32"], got[f"{name}_u16"]
        differ = int((f32 != eager[name][0]).sum())
        np.testing.assert_allclose(f32, eager[name][0], rtol=1e-5, atol=0,
                                   err_msg=f"artifact {name}")
        du16 = int(np.abs(u16.astype(np.int64) - eager[name][1].astype(np.int64)).max())
        if du16 > 1 or (differ == 0 and du16):
            raise AssertionError(f"artifact {name}: u16 wire off by {du16}")
        out[name].update(load_s=info["load_s"], pixels_differing=differ,
                         launches_per_batch=_per_batch(counts, batches))
        log(f"  (a) {name} artifact: {ART_IMAGES} images, depth "
            + ("bit for bit" if differ == 0 else f"{differ} pixels differ (rtol 1e-5)")
            + f" with the predictor, u16 max|d| {du16}; launches a batch "
            f"{_per_batch(counts, batches)} = the predictor's")

    # (b) int8 against the CPU: every site's conv on the same input
    # exactly, then end to end at the relative mean |d| of int8 against
    # bf16.  End to end the two runs quantize apart wherever an input
    # lies within rounding of a .5 step (one ulp of fp32; in bf16 an ulp
    # of a near-max input is half a step), and each flip moves what lies
    # downstream into more flips: the depth differs at about the size of
    # the quantization noise itself, in fp32 too
    few = images[:INT8_CPU_IMAGES]
    out["int8_vs"] = {}
    for dtype, sc in by_dtype.items():
        c = _with(cfgs["int8"], **{"model.dtype": dtype})
        card = (eager["int8"][0][:INT8_CPU_IMAGES] if c == cfgs["int8"] else
                BatchedPredictor(c, sd, batch_size=INT8_CPU_IMAGES,
                                 quant_scales=sc).predict(few))
        cpu, n_sites, site_rel = art_int8_sites(c, sd, sc, few)
        d = np.abs(card - cpu)
        rel = float(d.mean() / np.abs(cpu).mean())
        out["int8_vs"][f"cpu_{dtype}"] = {"max_m": float(d.max()), "mean_m": float(d.mean()),
                                          "rel_mean": rel, "site_max_rel": site_rel}
        log(f"  (b) int8, {dtype}: the conv of all {n_sites} sites on the CPU forward's "
            f"inputs, card vs CPU: int32 sums equal, output max rel {site_rel:.3g}; end to "
            f"end max|d| {d.max():.3g} m, mean {d.mean():.3g} m, relative mean {rel:.4f}")
        if rel >= INT8_VS_BF16:
            raise AssertionError(f"int8 card vs CPU ({dtype}): {out['int8_vs']}")
    q, bf16 = eager["int8"][0], eager["unfused"][0]
    rel = float(np.abs(q - bf16).mean() / np.abs(bf16).mean())
    out["int8_vs"]["bf16_rel_mean"] = rel
    log(f"  (b) int8 vs the card's bf16 forward, {ART_IMAGES} images: relative mean |d| "
        f"{rel:.4f}")
    if rel >= INT8_VS_BF16:
        raise AssertionError(f"int8 vs bf16: {rel} (bound {INT8_VS_BF16})")
    out["timing"] = art_timing({"bf16": preds["unfused"], "int8": preds["int8"]}, images)
    del preds
    launches["artifact_eval_int8"], out["eval_int8"] = art_eval_int8(n_gn, disk)
    out["serve"] = art_serve(paths["all"])
    torch.backends.cudnn.deterministic = False
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 24 took {out['seconds']:.1f} s")
    return out, launches


# --------------------------------------------------------------- phase 25

VARIANT = {"model.upsample": "deconv", "model.multiscale_heads": True}  # the main path
ALL_FLAGS = {**FUSED, **FUSION, **FUSED_V1}  # every fused flag
VARIANT_STEPS = 6  # (b): steps a stage, the host clock over steps 2-6
VARIANT_CLI_STEPS = 3  # (d): train_torch.py steps a stage
VARIANT_GN_DECONV = 16  # GN+ELU sites a deconv net: stem, 10 encoder, 5 fusion
# (c): (tag, preset, overrides, the model kernels' launches a net); every
# case runs one forward and one stage-2 step at B=2, card against CPU
VARIANT_GRID = (
    ("add", "kitti", {"model.fusion": "add"}, {"group_norm_elu": 21}),
    ("add_bt", "kitti", {"model.fusion": "add", "model.use_pallas_convgn_bt": True},
     {"group_norm_elu": 11, "conv_gn_elu_bt": 10}),
    ("norm_none", "kitti", {"model.norm": "none", **ALL_FLAGS}, {}),
    ("relu", "kitti", {"model.activation": "relu", **ALL_FLAGS}, {}),
    ("gelu", "kitti", {"model.activation": "gelu", **ALL_FLAGS}, {}),
    ("leaky_relu", "kitti", {"model.activation": "leaky_relu", **ALL_FLAGS}, {}),
    ("deconv_gn", "kitti", {**VARIANT, "model.deconv_gn": True}, {"group_norm_elu": 21}),
    ("deconv_lecun", "kitti", {"model.upsample": "deconv", "model.deconv_init": "lecun"},
     {"group_norm_elu": VARIANT_GN_DECONV}),
    ("deconv_nyu", "nyu", VARIANT, {"group_norm_elu": VARIANT_GN_DECONV}),
)


def variant_vs_cpu(tag, cfg, per_net, seed):
    """Phase 25 (c): one stage-2 step of a variant at B=2, full width, on
    the card (fp32, TF32 off) and on the CPU (fp32), same weights
    (init_params, the D-net's decoder in the G-net) and batch: the
    G-net's depth (rtol 1e-4, atol 1e-3 m, phase 4's bound), the loss
    terms (rtol 1e-4) and the stem's gradients (1e-3 of their largest
    magnitude), phase 9's bounds; the card's launches exact."""
    from gdn_tpu_torch.checkpoint import init_params, transfer_stage1_decoder
    from gdn_tpu_torch.config import _with
    from gdn_tpu_torch.data.synthetic import synthetic_batch
    from gdn_tpu_torch.models import DtoDNet, RtoDNet
    from gdn_tpu_torch.train.steps import _stage2_loss

    c = _with(cfg, **{"model.dtype": "float32"})
    gen = torch.Generator()
    d_sd = init_params(c.model, gen.manual_seed(seed), in_channels=1)
    g_sd = transfer_stage1_decoder(init_params(c.model, gen.manual_seed(seed + 1)), d_sd)
    batch = synthetic_batch(torch.Generator().manual_seed(3), 2, *c.model.image_size,
                            c.model.max_depth)
    watch = ("encoder.stem.Conv_0.kernel", "encoder.stem.gn_scale"
             if c.model.norm == "group" else "encoder.stem.Conv_0.bias")
    t0 = time.perf_counter()
    res = {}
    for dev in ("cpu", "cuda"):
        g, d = RtoDNet(c.model), DtoDNet(c.model)
        g.load_state_dict(g_sd)
        d.load_state_dict(d_sd)
        g, d = g.to(dev), d.to(dev).requires_grad_(False)
        g.decoder.requires_grad_(False)
        seen = {}
        hook = g.register_forward_hook(
            lambda m, i, o: seen.update(depth=o["depth"].detach().cpu().numpy()))
        if dev == "cuda":
            torch.cuda.synchronize()
            reset_counts()
        terms = _stage2_loss(g, d, {k: v.to(dev) for k, v in batch.items()}, c)
        terms["total"].backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = read_counts()
        hook.remove()
        params = dict(g.named_parameters())
        res[dev] = (seen["depth"], {k: float(v.detach()) for k, v in terms.items()},
                    {k: params[k].grad.detach().cpu() for k in watch})
    expect_counts(f"variant {tag}", counts, fused_loss_fwd=1, fused_loss_bwd=1,
                  **{k: 2 * v for k, v in per_net.items()})
    (cpu_d, cpu_t, cpu_g), (card_d, card_t, card_g) = res["cpu"], res["cuda"]
    np.testing.assert_allclose(card_d, cpu_d, rtol=1e-4, atol=1e-3,
                               err_msg=f"variant {tag}: depth")
    for k, v in card_t.items():
        if abs(v - cpu_t[k]) > 1e-4 * abs(cpu_t[k]):
            raise AssertionError(f"variant {tag}: card fp32 {k}={v} vs CPU {cpu_t[k]}")
    rel = {}
    for k in watch:
        err = (card_g[k] - cpu_g[k]).abs().max().item()
        scale = cpu_g[k].abs().max().item()
        rel[k] = err / scale
        if err > 1e-3 * scale:
            raise AssertionError(f"variant {tag}: grad {k}: max|d| {err:.3g} of {scale:.3g}")
    out = {"depth_max_abs_m": float(np.abs(card_d - cpu_d).max()),
           "terms_card": card_t, "terms_cpu": cpu_t, "grad_rel_err": rel,
           "launches_per_step": {k: v for k, v in counts.items() if v},
           "seconds": time.perf_counter() - t0}
    log(f"  (c) {tag}: depth max|card-CPU| {out['depth_max_abs_m']:.3g} m; terms within "
        f"1e-4 ({', '.join(sorted(card_t))}); stem grads {max(rel.values()):.3g} of their "
        f"largest; launches a step {counts_text(counts)} ({out['seconds']:.1f} s)")
    return out, counts


def variants_cli():
    """Phase 25 (d): scripts/train_torch.py --upsample deconv --multiscale,
    both stages; scripts/eval_torch.py on what it wrote (config.json
    brings the variant back); scripts/export_artifact_torch.py of its
    stage 2, loaded in a fresh process (phase 24's loader) and held
    against the checkpoint predictor: depth and launches a batch."""
    from gdn_tpu_torch import metrics as M
    from gdn_tpu_torch.checkpoint import load_config, load_params
    from gdn_tpu_torch.cli import apply_saved_model_config, build_config

    root = os.path.join(OUT, "variants_cli")
    shutil.rmtree(root, ignore_errors=True)
    steps, launches, out = VARIANT_CLI_STEPS, {}, {}
    train = load_script("train_torch")
    for mode, nets in (("DtoD", 1), ("RtoD", 2)):
        torch.cuda.synchronize()
        reset_counts()
        train.main(["--mode", mode, "--dataset", "synthetic", "--upsample", "deconv",
                    "--multiscale", "--epochs", "1", "--steps_per_epoch", str(steps),
                    "--log_every", "1", "--ckpt_dir", root])
        torch.cuda.synchronize()
        launches[f"variants_cli_{mode}"] = counts = read_counts()
        expect_counts(f"train_torch.py --upsample deconv --multiscale {mode}", counts,
                      fused_loss_fwd=steps, fused_loss_bwd=steps,
                      group_norm_elu=VARIANT_GN_DECONV * nets * steps)
    stage2 = os.path.join(root, "stage2")
    saved = load_config(stage2).model
    recs = [json.loads(line) for line in open(os.path.join(root, "train_log.jsonl"))]
    scales = [r["scales"] for r in recs if "scales" in r]
    if (saved.upsample, saved.multiscale_heads) != ("deconv", True) or len(scales) != 2 * steps:
        raise AssertionError(f"train_torch.py wrote {saved}, {len(scales)} scales terms")
    torch.cuda.synchronize()
    reset_counts()
    ev = load_script("eval_torch").main(["--dataset", "synthetic", "--ckpt_dir", root,
                                         "--max_images", "16"])
    torch.cuda.synchronize()
    launches["variants_cli_eval"] = counts = read_counts()
    if not all(np.isfinite(ev[k]) for k in M.METRIC_NAMES):
        raise AssertionError(f"eval_torch.py on the deconv checkpoint: {ev}")
    out.update(scales_terms=scales, eval=ev)
    log(f"  (d) train_torch.py --upsample deconv --multiscale: {steps} steps a stage, "
        f"launches exact, scales terms {[f'{v:.4f}' for v in scales]}; eval_torch.py "
        f"--ckpt_dir (config.json: upsample={saved.upsample}, multiscale_heads="
        f"{saved.multiscale_heads}): rmse {ev['rmse']:.4f}, a1 {ev['a1']:.4f}, launches "
        f"{counts_text(counts)}")

    path = os.path.join(root, "deconv_multiscale.pt2")
    argv = ["--ckpt_dir", root, "--output", path, "--export_batch", str(BATCH)]
    ex = load_script("export_artifact_torch")
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        ex.main(argv)
        out["export_s"] = time.perf_counter() - t0
        args = ex.parse_args(argv)
        cfg = apply_saved_model_config(build_config(args), args, stage2)
        sd = load_params(stage2)
        h, w = cfg.model.image_size
        images = np.random.default_rng(25).integers(0, 256, (ART_IMAGES, h, w, 3), np.uint8)
        batches = -(-ART_IMAGES // BATCH)
        _, f32, u16, counts = _eager(cfg, sd, images)
        launches["variants_artifact_eager"] = counts
        expect_counts("deconv + multiscale predictor", counts,
                      group_norm_elu=VARIANT_GN_DECONV * batches)
        np.save(os.path.join(root, "images.npy"), images)
        run = subprocess.run(
            [sys.executable, "-c", ART_LOADER, ROOT, os.path.join(root, "images.npy"),
             os.path.join(root, "depths.npz"), json.dumps({"deconv_multiscale": path})],
            capture_output=True, text=True, timeout=600, cwd=ROOT)
        if run.returncode != 0:
            raise AssertionError(f"the artifact loader failed: {run.stderr[-4000:]}")
    finally:
        torch.backends.cudnn.deterministic = False
    loaded = json.loads(run.stdout.strip().splitlines()[-1])
    info = loaded["info"]["deconv_multiscale"]
    launches["variants_artifact"] = info["counts"]
    if info["counts"] != counts or info["batch"] != BATCH:
        raise AssertionError(f"deconv artifact: {info} vs the predictor's launches {counts}")
    got = np.load(os.path.join(root, "depths.npz"))
    differ = int((got["deconv_multiscale_f32"] != f32).sum())
    np.testing.assert_allclose(got["deconv_multiscale_f32"], f32, rtol=1e-5, atol=0,
                               err_msg="deconv artifact")
    du16 = int(np.abs(got["deconv_multiscale_u16"].astype(np.int64)
                      - u16.astype(np.int64)).max())
    if du16 > 1 or (differ == 0 and du16):
        raise AssertionError(f"deconv artifact: u16 wire off by {du16}")
    out.update(pixels_differing=differ, mb=os.path.getsize(path) / 1e6,
               launches_per_batch=_per_batch(counts, batches))
    log(f"  (d) export_artifact_torch.py: {out['mb']:.1f} MB in {out['export_s']:.1f} s; "
        f"loaded in a fresh process: depth "
        + ("bit for bit" if differ == 0 else f"{differ} pixels differ (rtol 1e-5)")
        + f" with the checkpoint predictor, u16 max|d| {du16}; launches a batch "
        f"{_per_batch(counts, batches)} = the predictor's")
    return out, launches


def phase_variants(cfg, sd):
    """Phase 25: the model variants (see the module docstring).  ``cfg``
    and ``sd``: phase 4's resize_conv configuration and weights, served
    beside the deconv ones in the same call."""
    from gdn_tpu_torch.checkpoint import init_params
    from gdn_tpu_torch.config import _with, kitti_config, nyu_config

    t0 = time.perf_counter()
    out, launches = {"device": smi_line()}, {}
    cfg_v = _with(cfg, **VARIANT)
    cfg_vf = _with(cfg_v, **FUSED)
    cfg_vu = _with(cfg_v, **FUSION)
    sd_v = init_params(cfg_v.model, torch.Generator().manual_seed(0))
    fused_per_net = {"group_norm_elu": 1, "conv_gn_elu_s2": 5, "conv_gn_elu_bt": 5,
                     "fusion_bt": 5}
    fusion_per_net = {"group_norm_elu": 11, "fusion_block": 5}

    # (a) serving at batch 8: three deconv configurations and resize_conv
    for tag, c, s, per_batch, extra in (
            ("deconv", cfg_v, sd_v, {"group_norm_elu": VARIANT_GN_DECONV},
             {"bf16_cpu": True}),
            ("deconv_fused", cfg_vf, sd_v, fused_per_net, {}),
            ("deconv_fusion", cfg_vu, sd_v, fusion_per_net, {}),
            ("resize_conv", cfg, sd, {"group_norm_elu": 21}, {})):
        log(f"  (a) serving, {tag}:")
        _, counts, info = phase_slice(c, s, per_batch, f"serving_variant_{tag}", **extra)
        launches[f"serving_variant_{tag}"] = counts
        prof = info["profile"]
        if prof is not None:
            info["all_launches_per_batch"] = prof["kernel_launches"] / (64 // BATCH)
        out[f"serving_{tag}"] = info
    rows = {t: out[f"serving_{t}"] for t in ("deconv", "deconv_fused", "deconv_fusion",
                                             "resize_conv")}
    log("  (a) ms a batch of 8 (host clock) / device busy ms / idle / all launches a batch: "
        + "; ".join(f"{t} {r['ms_per_batch']:.2f} / "
                    + (f"{r['profile']['device_busy_ms'] / 8:.2f} / "
                       f"{r['profile']['idle_share']:.1%} / "
                       f"{r['all_launches_per_batch']:.0f}" if r["profile"] else "not measured")
                    for t, r in rows.items()))

    # (b) two-stage training, B=32, unfused and fused, then card vs CPU
    for tag, c, per_net in (("deconv", cfg_v, {"group_norm_elu": VARIANT_GN_DECONV}),
                            ("deconv_fused", cfg_vf, fused_per_net)):
        log(f"  (b) training, {tag}:")
        tr, tl, _, s2, d_net = phase_train(c, VARIANT_STEPS, per_net, f"training_variant_{tag}")
        for stage in ("stage1", "stage2"):
            if "scales" not in tr[stage]["last_terms"]:
                raise AssertionError(f"{tag} {stage}: no scales term in the log")
        launches.update({f"training_variant_{tag}_{k}": v for k, v in tl.items()})
        out[f"training_{tag}"] = tr
        if tag == "deconv":
            log("  (b) one stage-2 step, card vs CPU, B=2:")
            out["vs_cpu"] = phase_vs_cpu(c, s2, d_net)
            if "scales" not in out["vs_cpu"]["terms"]["card32"]:
                raise AssertionError("the stage-2 step vs the CPU has no scales term")
        del s2, d_net

    # (c) the variant grid at B=2, card against CPU
    out["grid"] = {}
    for i, (tag, preset, over, per_net) in enumerate(VARIANT_GRID):
        c = (kitti_config if preset == "kitti" else nyu_config)(
            **{"model.use_pallas_gn": True, **over})
        out["grid"][tag], launches[f"variant_{tag}"] = variant_vs_cpu(tag, c, per_net,
                                                                      100 + 2 * i)

    # (d) the entry points
    out["cli"], cli_launches = variants_cli()
    launches.update(cli_launches)
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 25 took {out['seconds']:.1f} s")
    return out, launches


# --------------------------------------------------------------- phase 26

FG = {"train.fused_guidance": True}
# (a), (b): (tag, overrides of phase 8's configuration, the model kernels'
# launches a stage-2 step at B=32; each step also launches the two loss
# kernels once).  The D-net's encoder runs without grad (11 GN+ELU), the
# G-net's under grad (11), the shared decoder at 2B (10); the VJP runs the
# decoder again on the G half (10); the paired ladder is one ladder (11).
KNOBS = (
    ("two_net", {}, {"group_norm_elu": 42}),
    ("fused_guidance", FG, {"group_norm_elu": 32}),
    ("fused_guidance_vjp", {**FG, "train.fused_guidance_vjp": True}, {"group_norm_elu": 42}),
    ("fused_encoders", {**FG, "train.fused_encoders": True}, {"group_norm_elu": 21}),
    ("fused_encoders_fused", {**FG, "train.fused_encoders": True, **FUSED},
     {"group_norm_elu": 16, "fusion_bt": 5}),
    ("fused_guidance_fusion", {**FG, **FUSION},
     {"group_norm_elu": 22, "upsample": 5, "fusion_block": 5}),
)
KNOB_TIMED = 3  # (a): timed steps, after one untimed
KNOB_K = 4  # (c): steps_per_call
KNOB_CLI_STEPS = 4  # (e): train_torch.py steps a stage
# (d): remat_policy -> how many times the G-net's GroupNorm+ELU sites
# launch a step (the D-net's 21 launch once): the kernels launch through
# ctypes, so every policy that recomputes launches them again
REMAT_RUNS = {"off": 1, "nothing_saveable": 2, "dots_saveable": 2, "checkpoint_dots": 2,
              "dots_with_no_batch_dims_saveable": 2,
              "checkpoint_dots_with_no_batch_dims": 2, "everything_saveable": 1}


def _knob_nets(c, g_sd, d_sd, dev="cuda"):
    """A G-net (decoder frozen) and a frozen D-net of config ``c`` on
    ``dev`` from the state dicts."""
    from gdn_tpu_torch.models import DtoDNet, RtoDNet

    g, d = RtoDNet(c.model), DtoDNet(c.model)
    g.load_state_dict(g_sd)
    d.load_state_dict(d_sd)
    g, d = g.to(dev), d.to(dev).requires_grad_(False)
    g.decoder.requires_grad_(False)
    return g, d


def _knob_weights(cfg, seed):
    """(G-net state dict with the D-net's decoder, D-net state dict):
    init_params draws of seeds ``seed`` + 1 and ``seed``."""
    from gdn_tpu_torch.checkpoint import init_params, transfer_stage1_decoder

    gen = torch.Generator()
    d_sd = init_params(cfg.model, gen.manual_seed(seed), in_channels=1)
    return transfer_stage1_decoder(init_params(cfg.model, gen.manual_seed(seed + 1)),
                                   d_sd), d_sd


def knobs_steps(cfg, g_sd, d_sd):
    """Phase 26 (a): each KNOBS configuration's stage-2 step at B=32, bf16,
    from the same weights: launches a step exact, ms/step (host clock,
    KNOB_TIMED steps after one), peak allocated memory, one profiled
    step (device busy, idle share, all launches)."""
    from gdn_tpu_torch.config import _with
    from gdn_tpu_torch.data.synthetic import synthetic_batch
    from gdn_tpu_torch.train.state import TrainState
    from gdn_tpu_torch.train.steps import make_stage2_step

    h, w = cfg.model.image_size
    batch = synthetic_batch(torch.Generator(device="cuda").manual_seed(26), TRAIN_BATCH,
                            h, w, cfg.model.max_depth)
    out, launches = {}, {}
    for tag, over, per_step in KNOBS:
        c = _with(cfg, **over)
        g, d = _knob_nets(c, g_sd, d_sd)
        state = TrainState(g, c.train, 10, freeze_decoder=True)
        step = make_stage2_step(c)
        step(state, d, batch)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(KNOB_TIMED):
            step(state, d, batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / KNOB_TIMED
        peak = torch.cuda.max_memory_allocated()
        counts = read_counts()
        expect_counts(f"knobs {tag}", counts, fused_loss_fwd=KNOB_TIMED,
                      fused_loss_bwd=KNOB_TIMED,
                      **{k: v * KNOB_TIMED for k, v in per_step.items()})
        launches[f"knobs_{tag}"] = counts
        prof = profile_train_step(c, state, d, batch, f"knobs_{tag}")
        out[tag] = {"ms_per_step": ms, "peak_allocated_bytes": peak,
                    "allocated_before_bytes": base,
                    "launches_per_step": {k: v // KNOB_TIMED for k, v in counts.items() if v},
                    "profile": prof}
        log(f"  (a) {tag}: {ms:.1f} ms/step (host clock, {KNOB_TIMED} steps), peak "
            f"{peak / 2**30:.2f} GiB allocated ({(peak - base) / 2**30:.2f} above the "
            f"state), launches a step {out[tag]['launches_per_step']}"
            + (f"; profiled step: wall {prof['wall_ms']:.1f} ms, busy "
               f"{prof['device_busy_ms']:.2f} ms (idle {prof['idle_share']:.1%}), "
               f"{prof['kernel_launches']} launches" if prof else "; profile not measured"))
        del g, d, state, step
    return out, launches


def knobs_vs_cpu(cfg, g_sd, d_sd):
    """Phase 26 (b): one stage-2 step of each KNOBS configuration at B=2,
    card (fp32, TF32 off) against CPU (fp32), phase 9's bounds (terms
    rtol 1e-4, stem gradients 1e-3 of their largest); and each fused
    configuration against the two-net step with the same model flags on
    the card, fp32: terms rtol 1e-5, gradients phase 9's bound."""
    from gdn_tpu_torch.config import _with
    from gdn_tpu_torch.data.synthetic import synthetic_batch
    from gdn_tpu_torch.train.steps import _stage2_loss_fn

    batch = synthetic_batch(torch.Generator().manual_seed(3), 2, *cfg.model.image_size,
                            cfg.model.max_depth)
    watch = ("encoder.stem.Conv_0.kernel", "encoder.stem.gn_scale")

    def run(c, dev):
        g, d = _knob_nets(c, g_sd, d_sd, dev)
        terms = _stage2_loss_fn(c)(g, d, {k: v.to(dev) for k, v in batch.items()}, c)
        terms["total"].backward()
        params = dict(g.named_parameters())
        return ({k: float(v.detach()) for k, v in terms.items()},
                {k: params[k].grad.detach().cpu() for k in watch})

    def held(got, want, rtol, what):
        for k, v in got[0].items():
            if abs(v - want[0][k]) > rtol * abs(want[0][k]):
                raise AssertionError(f"{what}: {k}={v} vs {want[0][k]}")
        rel = {}
        for k in watch:
            err = (got[1][k] - want[1][k]).abs().max().item()
            scale = want[1][k].abs().max().item()
            rel[k] = err / scale
            if err > 1e-3 * scale:
                raise AssertionError(f"{what}: grad {k} max|d| {err:.3g} of {scale:.3g}")
        return rel

    out, two_net = {}, {}
    for tag, over, _ in KNOBS:
        t0 = time.perf_counter()
        c = _with(cfg, **{**over, "model.dtype": "float32"})
        card, cpu = run(c, "cuda"), run(c, "cpu")
        row = {"terms_card": card[0], "terms_cpu": cpu[0],
               "grad_rel_err_cpu": held(card, cpu, 1e-4, f"knobs {tag} card vs CPU")}
        flags = {k: v for k, v in over.items() if k.startswith("model.")}
        if tag == "two_net":
            two_net[()] = card
        else:
            if tuple(flags) not in two_net:
                two_net[tuple(flags)] = run(_with(cfg, **flags, **{"model.dtype": "float32"}),
                                            "cuda")
            ref = two_net[tuple(flags)]
            row["grad_rel_err_two_net"] = held(card, ref, 1e-5,
                                               f"knobs {tag} vs the two-net step")
            row["terms_rel_two_net"] = max(abs(v - ref[0][k]) / abs(ref[0][k])
                                           for k, v in card[0].items())
        row["seconds"] = time.perf_counter() - t0
        out[tag] = row
        log(f"  (b) {tag}: card vs CPU terms within 1e-4, stem grads "
            f"{max(row['grad_rel_err_cpu'].values()):.3g} of their largest"
            + (f"; vs the two-net step on the card: terms {row['terms_rel_two_net']:.3g} "
               f"relative, grads {max(row['grad_rel_err_two_net'].values()):.3g}"
               if "terms_rel_two_net" in row else "") + f" ({row['seconds']:.1f} s)")
    return out


def knobs_multistep(cfg, g_sd, d_sd):
    """Phase 26 (c): steps_per_call=KNOB_K in both stages, unfused, B=32,
    bf16, EMA 0.99, cuDNN's deterministic algorithms: one multistep call
    against KNOB_K single steps from the same state, parameters, EMA and
    Adam moments bit-identical; launches a call; ms an update of each."""
    from gdn_tpu_torch.config import _with
    from gdn_tpu_torch.data.synthetic import synthetic_batch
    from gdn_tpu_torch.models import DtoDNet
    from gdn_tpu_torch.train.state import TrainState
    from gdn_tpu_torch.train.steps import (
        make_stage1_multistep, make_stage1_step, make_stage2_multistep, make_stage2_step,
    )

    c = _with(cfg, **{"train.ema_decay": 0.99, "train.steps_per_call": KNOB_K})
    h, w = c.model.image_size
    gen = torch.Generator(device="cuda").manual_seed(27)
    batches = [synthetic_batch(gen, TRAIN_BATCH, h, w, c.model.max_depth)
               for _ in range(KNOB_K)]
    stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    n_gn = len(gn_sites(cfg.model))
    out, launches = {}, {}
    torch.backends.cudnn.deterministic = True
    try:
        for stage, nets in (("stage1", 1), ("stage2", 2)):
            def fresh():
                if stage == "stage1":
                    d = DtoDNet(c.model)
                    d.load_state_dict(d_sd)
                    return TrainState(d.cuda(), c.train, 10), ()
                g, d = _knob_nets(c, g_sd, d_sd)
                return TrainState(g, c.train, 10, freeze_decoder=True), (d,)

            single = make_stage1_step(c) if stage == "stage1" else make_stage2_step(c)
            multi = (make_stage1_multistep(c, KNOB_K) if stage == "stage1"
                     else make_stage2_multistep(c, KNOB_K))
            st, extra = fresh()
            single(st, *extra, batches[0])  # cuDNN's first calls, off the clock
            row = {}
            for how in ("single", "multi"):
                st, extra = fresh()
                torch.cuda.synchronize()
                reset_counts()
                t0 = time.perf_counter()
                if how == "single":
                    for b in batches:
                        st, _ = single(st, *extra, b)
                else:
                    st, _ = multi(st, *extra, stacked)
                torch.cuda.synchronize()
                row[f"{how}_ms_per_update"] = 1e3 * (time.perf_counter() - t0) / KNOB_K
                counts = read_counts()
                expect_counts(f"knobs multistep {stage} {how}", counts,
                              group_norm_elu=n_gn * nets * KNOB_K,
                              fused_loss_fwd=KNOB_K, fused_loss_bwd=KNOB_K)
                launches[f"knobs_multistep_{stage}_{how}"] = counts
                row[how] = _snapshot(st)
            diff = _snap_diff(row.pop("single"), row.pop("multi"))
            if any(diff.values()):
                raise AssertionError(f"{stage}: multistep vs single steps differ: {diff}")
            row.update(max_diff=diff, launches_per_call={k: v for k, v in counts.items() if v})
            out[stage] = row
            log(f"  (c) {stage}, steps_per_call={KNOB_K}: one call vs {KNOB_K} single steps "
                f"bit-identical {diff}; launches a call {row['launches_per_call']}; "
                f"{row['multi_ms_per_update']:.1f} ms an update in the call, "
                f"{row['single_ms_per_update']:.1f} single (host clock, one pass each)")
    finally:
        torch.backends.cudnn.deterministic = False
    return out, launches


def knobs_remat(cfg, g_sd, d_sd):
    """Phase 26 (d): stage 2 at B=32, bf16, unfused, remat off and each
    ported policy: gradients of one step against remat off (within
    GRAD_TOL_BF16 of each tensor's largest; where bit-identical, said),
    launches a step exact (the recompute's included), then peak allocated
    memory and ms/step of LIFE_TIMED steps and one profiled step."""
    from gdn_tpu_torch.config import _with
    from gdn_tpu_torch.data.synthetic import synthetic_batch
    from gdn_tpu_torch.train.state import TrainState
    from gdn_tpu_torch.train.steps import _stage2_loss, make_stage2_step

    h, w = cfg.model.image_size
    batch = synthetic_batch(torch.Generator(device="cuda").manual_seed(28), TRAIN_BATCH,
                            h, w, cfg.model.max_depth)
    n_gn = len(gn_sites(cfg.model))
    out, launches, ref = {}, {}, None
    for policy, runs in REMAT_RUNS.items():
        over = ({"train.remat": False} if policy == "off"
                else {"train.remat": True, "train.remat_policy": policy})
        c = _with(cfg, **over)
        torch.backends.cudnn.deterministic = True
        g, d = _knob_nets(c, g_sd, d_sd)
        _stage2_loss(g, d, batch, c)["total"].backward()  # cuDNN's first calls
        g.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        reset_counts()
        terms = _stage2_loss(g, d, batch, c)
        terms["total"].backward()
        torch.cuda.synchronize()
        counts = read_counts()
        torch.backends.cudnn.deterministic = False
        expect_counts(f"knobs remat {policy}", counts, fused_loss_fwd=1, fused_loss_bwd=1,
                      group_norm_elu=n_gn * (runs + 1))
        grads = {k: p.grad.detach().clone() for k, p in g.named_parameters()
                 if p.requires_grad}
        terms = {k: float(v.detach()) for k, v in terms.items()}
        row = {"launches_per_step": {k: v for k, v in counts.items() if v}}
        if ref is None:
            ref = (terms, grads)
        else:
            rel = max(((grads[k] - ref[1][k]).abs().max()
                       / ref[1][k].abs().max().clamp_min(1e-30)).item() for k in grads)
            if rel > GRAD_TOL_BF16:
                raise AssertionError(f"remat {policy}: gradients off by {rel:.3g} of their max")
            row.update(grad_max_rel_diff=rel, terms_equal=terms == ref[0],
                       grads_bit_identical=all(torch.equal(grads[k], ref[1][k])
                                               for k in grads))
        launches[f"knobs_remat_{policy}"] = counts
        del g, d, grads
        g, d = _knob_nets(c, g_sd, d_sd)
        state = TrainState(g, c.train, 10, freeze_decoder=True)
        step = make_stage2_step(c)
        step(state, d, batch)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(LIFE_TIMED):
            step(state, d, batch)
        torch.cuda.synchronize()
        row["ms_per_step"] = 1e3 * (time.perf_counter() - t0) / LIFE_TIMED
        row["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
        row["peak_above_before_bytes"] = row["peak_allocated_bytes"] - base
        counts = read_counts()
        expect_counts(f"knobs remat {policy} timed", counts, fused_loss_fwd=LIFE_TIMED,
                      fused_loss_bwd=LIFE_TIMED, group_norm_elu=n_gn * (runs + 1) * LIFE_TIMED)
        launches[f"knobs_remat_{policy}_timed"] = counts
        row["profile"] = prof = profile_train_step(c, state, d, batch, f"knobs_remat_{policy}")
        out[policy] = row
        log(f"  (d) remat {policy}: "
            + ("" if policy == "off" else
               f"grads within {row['grad_max_rel_diff']:.3g} of their max"
               + (" (bit-identical)" if row["grads_bit_identical"] else "")
               + f", terms {'equal' if row['terms_equal'] else 'differ'}; ")
            + f"launches a step {row['launches_per_step']}; {row['ms_per_step']:.1f} ms/step"
            f" (host clock, {LIFE_TIMED} steps); peak {row['peak_allocated_bytes'] / 2**30:.2f}"
            f" GiB ({row['peak_above_before_bytes'] / 2**30:.2f} above the state)"
            + (f"; profiled step: busy {prof['device_busy_ms']:.2f} ms (idle "
               f"{prof['idle_share']:.1%}), {prof['kernel_launches']} launches"
               if prof else ""))
        del g, d, state, step
    return out, launches


def knobs_cli():
    """Phase 26 (e): scripts/train_torch.py --steps_per_call 2
    --fused_guidance, KNOB_CLI_STEPS steps a stage: launches exact, the
    log's steps, the saved config."""
    from gdn_tpu_torch.checkpoint import load_config

    root = os.path.join(OUT, "knobs_cli")
    shutil.rmtree(root, ignore_errors=True)
    train = load_script("train_torch")
    launches, out = {}, {}
    for mode, gn in (("DtoD", 21), ("RtoD", 32)):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        st = train.main(["--mode", mode, "--dataset", "synthetic", "--epochs", "1",
                         "--steps_per_epoch", str(KNOB_CLI_STEPS), "--steps_per_call", "2",
                         "--fused_guidance", "--log_every", "2", "--ckpt_dir", root])
        torch.cuda.synchronize()
        launches[f"knobs_cli_{mode}"] = counts = read_counts()
        expect_counts(f"train_torch.py --steps_per_call 2 --fused_guidance {mode}", counts,
                      group_norm_elu=gn * KNOB_CLI_STEPS, fused_loss_fwd=KNOB_CLI_STEPS,
                      fused_loss_bwd=KNOB_CLI_STEPS)
        if st.step != KNOB_CLI_STEPS:
            raise AssertionError(f"{mode}: stopped at step {st.step}")
        out[mode] = {"seconds": time.perf_counter() - t0, "launches": counts}
    recs = [json.loads(line) for line in open(os.path.join(root, "train_log.jsonl"))]
    saved = load_config(os.path.join(root, "stage2")).train
    if [r["step"] for r in recs] != [2, 4, 2, 4] or not (
            saved.fused_guidance and saved.steps_per_call == 2):
        raise AssertionError(f"train_torch.py log steps {[r['step'] for r in recs]}, "
                             f"saved {saved}")
    out["log"] = recs
    log(f"  (e) train_torch.py --steps_per_call 2 --fused_guidance: {KNOB_CLI_STEPS} steps a "
        f"stage, logged at steps {[r['step'] for r in recs]}, launches "
        f"{counts_text(launches['knobs_cli_DtoD'])} / {counts_text(launches['knobs_cli_RtoD'])}"
        f", config.json keeps both knobs ({out['DtoD']['seconds']:.1f} + "
        f"{out['RtoD']['seconds']:.1f} s)")
    return out, launches


def knobs_gn_paired(cfg):
    """Phase 26 (f): the GroupNorm+ELU kernel against its plain version at
    every shape of the paired encoder ladder (B=32, C = 2 x the encoder's
    width, 2G = 16 groups, bf16), as phase 3: values, (B, 2, G)
    statistics, plan, device time (``queued_ms``) and bound."""
    from gdn_tpu_torch.kernels import groupnorm as gnk
    from gdn_tpu_torch.ops.groupnorm import pick_groups

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(29)
    shapes = sorted({(2 * c, h, w) for c, h, w in gn_sites(cfg.model)[:11]}, reverse=True)
    for c, h, w in shapes:
        g = 2 * pick_groups(c // 2, cfg.model.group_norm_groups)
        shape = (TRAIN_BATCH, c, h, w)
        x = _gn_input(shape, torch.bfloat16, gen)
        scale = torch.rand(c, device="cuda", generator=gen) + 0.5
        bias = torch.randn(c, device="cuda", generator=gen)
        what = f"group_norm_elu {shape} bf16, {g} groups (paired ladder)"
        err, serr, plan = gn_check(gnk.group_norm_elu, x, scale, bias, g, what)
        row = {"B": TRAIN_BATCH, "C": c, "H": h, "W": w, "groups": g, "dtype": "bfloat16",
               "max_abs_err": err, "stats_max_abs_err": serr, "plan": plan._asdict(),
               "bound_ms": bound_ms(*gn_work(shape, 2))}
        # late in the process CUPTI has recorded none of these launches
        # (PR 16's proof runs): the card's time comes from queued events
        row["ms"] = queued_ms([lambda: gnk.group_norm_elu(x, scale, bias, g)])
        rows.append(row)
        log(f"  (f) {what}: max|k-p| {err:.3g}, stats {serr:.3g}; {plan_text(plan)}; "
            f"device {row['ms'] * 1e3:.1f} us, bound {row['bound_ms'] * 1e3:.1f} us "
            f"({row['bound_ms'] / row['ms']:.0%} of it reached)")
        del x
    return rows


def phase_knobs(cfg):
    """Phase 26: the training knobs of the JAX package's TrainConfig (see
    the module docstring).  ``cfg``: phase 8's configuration."""
    t0 = time.perf_counter()
    out, launches = {"device": smi_line()}, {}
    g_sd, d_sd = _knob_weights(cfg, 26)
    out["steps"], more = knobs_steps(cfg, g_sd, d_sd)
    launches.update(more)
    out["vs_cpu"] = knobs_vs_cpu(cfg, g_sd, d_sd)
    out["multistep"], more = knobs_multistep(cfg, g_sd, d_sd)
    launches.update(more)
    out["remat"], more = knobs_remat(cfg, g_sd, d_sd)
    launches.update(more)
    out["cli"], more = knobs_cli()
    launches.update(more)
    out["gn_paired"] = knobs_gn_paired(cfg)
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 26 took {out['seconds']:.1f} s")
    return out, launches


# --------------------------------------------------------------- phase 27

P27_STEPS = 3  # (a), (b): steps a stage
# (a), (b): bf16 gradients against one process, of each tensor's largest:
# the bound phases 21 (d) and 26 (d) hold bf16 gradients to (each rank's
# bf16 weight gradients round before the sum; one process rounds the sum)
BF16_GRAD_TOL = 0.05
P27_RANKS = 2  # ranks sharing the one card over gloo
P27_EVAL = (16, 8)  # (e): synthetic eval images (phase 23's split), eval batch
P27_CACHE_BATCHES = 4  # (f): sharded-cache batches whose rows are compared
# (a): kernels 1-3 by the name of their kernel in a rank's profile
P27_PROFILED = (("group_norm_elu", "gn_elu_coop"), ("fused_loss_fwd", "loss_forward"),
                ("fused_loss_bwd", "loss_backward"))
P27_VALID = (0.15, 0.40)  # mask density of rows 0-15 (rank 0) and 16-31 (rank 1)
# (c): the fused configurations whose one DP step launches kernels 4-9
P27_FUSED = (("all_flags", {**FUSED, **FUSION}),
             ("convgn_fusion", {**FUSED_V1, **FUSION}))


def p27_batches(cfg, n=P27_STEPS, seed=27):
    """Global batches of TRAIN_BATCH drawn on the host (numpy, seed):
    continuous depth in [1, 79] m and RGB, masks sparse as velodyne GT,
    the first half's ~P27_VALID[0] valid and the second half's
    ~P27_VALID[1]: rank 1 holds more than twice rank 0's valid pixels."""
    h, w = cfg.model.image_size
    rng = np.random.default_rng(seed)
    half = TRAIN_BATCH // 2
    p = np.repeat(np.float32(P27_VALID), half)[:, None, None, None]
    out = []
    for _ in range(n):
        out.append({
            "depth": torch.from_numpy(rng.uniform(1.0, 79.0, (TRAIN_BATCH, h, w, 1))
                                      .astype(np.float32)),
            "mask": torch.from_numpy((rng.random((TRAIN_BATCH, h, w, 1), np.float32) < p)
                                     .astype(np.float32)),
            "rgb": torch.from_numpy(rng.random((TRAIN_BATCH, h, w, 3), np.float32))})
    return out


def _p27_weights(cfg):
    """(D-net state dict, G-net state dict holding the D-net's decoder):
    init_params draws of seeds 27 and 28."""
    from gdn_tpu_torch.checkpoint import init_params, transfer_stage1_decoder

    gen = torch.Generator()
    d_sd = init_params(cfg.model, gen.manual_seed(27), in_channels=1)
    return d_sd, transfer_stage1_decoder(init_params(cfg.model, gen.manual_seed(28)), d_sd)


def _first_grads(state, out):
    """Keep in ``out`` the whole gradients of the first update (after the
    ranks' sum; tensor-parallel slices gathered), by parameter name: an
    optimizer pre-step hook."""
    from gdn_tpu_torch.parallel.mesh import full_tensor

    names = [k for k, p in state.net.named_parameters() if p.requires_grad]

    def hook(opt, args, kwargs):
        if out:
            return
        grads = {k: p.grad for k, p in zip(names, state.params)}
        if state.mode == "tp":
            grads = state._whole(grads)
        out.update({k: full_tensor(g).detach().float().cpu() for k, g in grads.items()})

    state.optimizer.register_step_pre_hook(hook)


def _timed_rows(batches, mesh, dev, stamps):
    """This rank's rows of each batch, uploaded, with the host clock at
    each draw in ``stamps`` (the steps' spacing)."""
    from gdn_tpu_torch.parallel.mesh import shard_batch

    for b in batches:
        stamps.append(time.perf_counter())
        yield {k: v.to(dev, non_blocking=True) for k, v in shard_batch(b, mesh).items()}
    stamps.append(time.perf_counter())


def _state_bytes(state):
    """(this rank's bytes of the trained parameters, of their Adam moments)."""
    from gdn_tpu_torch.parallel.mesh import local

    pb = sum(local(p).nbytes for p in state.params)
    ob = sum(local(v).nbytes for st in state.optimizer.state.values()
             for n, v in st.items() if n != "step")
    return pb, ob


def p27_train(cfg, d_sd, g_sd, batches, mesh, tag, stages=(1, 2), profile=True,
              record=None):
    """Stage 1 then stage 2 (or ``stages``) through train_stage1/2 from
    the same weights on ``batches`` (global), data parallel over ``mesh``
    (None: one process), the state placed by ``cfg.mesh``: the terms of
    every step (the loop's log, rank 0's under a mesh), the first
    update's gradients, ms/step on this rank's host clock (steps 2 on),
    the launches of each stage, the state's bytes on this rank, and one
    profiled stage-2 step (device busy).  ``record``: a list some probe
    fills during the steps (phase 28's GN+ELU channels), emptied at each
    stage and kept in the stage's record."""
    from gdn_tpu_torch.config import _with
    from gdn_tpu_torch.models import DtoDNet, RtoDNet
    from gdn_tpu_torch.parallel import multihost
    from gdn_tpu_torch.parallel.mesh import (
        data_group, param_mode, shard_batch, shard_frozen, shard_state,
    )
    from gdn_tpu_torch.train.loop import train_stage1, train_stage2
    from gdn_tpu_torch.train.state import TrainState
    from gdn_tpu_torch.train.steps import make_stage2_step
    from gdn_tpu_torch.utils.logging import MetricLogger

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = _with(cfg, **{"train.steps_per_epoch": len(batches), "train.log_every": 1,
                        "train.ckpt_dir": "", "data.batch_size": TRAIN_BATCH})
    out = {}
    for stage in stages:
        net = (DtoDNet if stage == 1 else RtoDNet)(cfg.model)
        net.load_state_dict(d_sd if stage == 1 else g_sd)
        state = TrainState(net.to(dev), cfg.train, len(batches), freeze_decoder=stage == 2)
        state, _ = shard_state(state, mesh, param_mode(cfg.mesh))
        grads, stamps = {}, []
        _first_grads(state, grads)
        jsonl = os.path.join(OUT, f"p27_{tag}_stage{stage}.jsonl")
        if os.path.exists(jsonl) and multihost.rank() == 0:
            os.remove(jsonl)
        logger = MetricLogger(prefix=f"{tag} stage{stage}", jsonl_path=jsonl)
        data = _timed_rows(batches, mesh, dev, stamps)
        torch.cuda.synchronize()
        reset_counts()
        if record is not None:
            record.clear()
        if stage == 1:
            state = train_stage1(cfg, data, epochs=1, state=state, logger=logger, mesh=mesh,
                                 device=dev)
        else:
            d_net = DtoDNet(cfg.model)
            d_net.load_state_dict(d_sd)
            d_net = shard_frozen(d_net.to(dev).requires_grad_(False), mesh,
                                 param_mode(cfg.mesh))
            state = train_stage2(cfg, data, d_net, epochs=1, state=state, logger=logger,
                                 mesh=mesh, device=dev)
        torch.cuda.synchronize()
        counts = read_counts()
        logger.close()
        steps_ms = [1e3 * (b - a) for a, b in zip(stamps[1:-1], stamps[2:])]
        rec = {"launches": counts, "grads": grads,
               "ms_per_step": sum(steps_ms) / max(len(steps_ms), 1),
               "bytes": _state_bytes(state)}
        if record is not None:
            rec["recorded"] = list(record)
        if multihost.rank() == 0:
            rec["terms"] = [{k: v for k, v in json.loads(line).items()
                             if k not in ("t", "step", "imgs_per_sec", "lr")}
                            for line in open(jsonl)]
        if stage == 2 and profile:
            step = make_stage2_step(cfg, **({} if mesh is None else dict(
                mesh=mesh, state_sharding=state.specs)))
            b = {k: v.to(dev) for k, v in shard_batch(batches[0], mesh).items()}
            try:  # one session on every rank: a retry on one alone would hang
                _, kernels, wall = profiled(lambda: step(state, d_net, b),
                                            tries=1 if mesh is not None else 4)
                busy = sum(us for us, _ in kernels.values()) / 1e3
                rec["profile"] = {"wall_ms": wall * 1e3, "device_busy_ms": busy,
                                  "idle_share": 1 - busy / (wall * 1e3),
                                  "kernel_launches": sum(n for _, n in kernels.values()),
                                  "calls": {name: sum(n for k, (_, n) in kernels.items()
                                                      if part in k)
                                            for name, part in P27_PROFILED}}
            except ProfilerShort as e:
                rec["profile"] = None
                log(f"  {tag} rank {multihost.rank()}: profile not measured ({e})")
            if mesh is not None:
                torch.distributed.barrier(group=data_group(mesh))
        out[f"stage{stage}"] = rec
    return out


def p27_rank(out_dir, weights):
    """The ranks of phase 27 (a)-(c), (e), (f): every result into
    ``out_dir/rank<r>.pt``."""
    sys.path.insert(0, ROOT)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from gdn_tpu_torch import kernels as port_kernels
    from gdn_tpu_torch.config import _with, kitti_config
    from gdn_tpu_torch.parallel import multihost
    from gdn_tpu_torch.parallel.mesh import create_mesh

    port_kernels.load_all()  # built by the parent: loads
    r = multihost.rank()
    cfg = kitti_config(**{"model.use_pallas_gn": True})
    mesh = create_mesh(0, device_type="cuda")
    d_sd, g_sd = torch.load(weights, weights_only=True).values()
    batches = p27_batches(cfg)
    res = {"rank": r, "backend": torch.distributed.get_backend(),
           "device": str(torch.cuda.current_device())}
    res["dp"] = p27_train(cfg, d_sd, g_sd, batches, mesh, f"dp_rank{r}")
    res["dp32"] = p27_train(_with(cfg, **{"model.dtype": "float32"}), d_sd, g_sd,
                            batches[:1], mesh, f"dp32_rank{r}", stages=(2,), profile=False)
    res["fsdp"] = p27_train(_with(cfg, **{"mesh.fsdp": True}), d_sd, g_sd, batches,
                            mesh, f"fsdp_rank{r}", stages=(2,), profile=False)
    res["fused"] = {}
    for tag, over in P27_FUSED:
        res["fused"][tag] = p27_train(_with(cfg, **over), d_sd, g_sd, batches[:1], mesh,
                                      f"{tag}_rank{r}", stages=(2,), profile=False)
    res["eval"] = p27_eval(cfg, g_sd, mesh)
    res["cache"] = p27_cache(cfg, mesh)
    torch.save(res, os.path.join(out_dir, f"rank{r}.pt"))


def p27_eval(cfg, g_sd, mesh):
    """(e): the G-net (fp32, TF32 off) on phase 23's synthetic eval
    split through evaluate(), data parallel over ``mesh``."""
    from gdn_tpu_torch.config import _with
    from gdn_tpu_torch.data.synthetic import SyntheticEvalDataset
    from gdn_tpu_torch.evaluate import evaluate
    from gdn_tpu_torch.models import RtoDNet
    from gdn_tpu_torch.train.steps import make_eval_forward

    n, bs = P27_EVAL
    c = _with(cfg, **{"model.dtype": "float32", "eval.batch_size": bs})
    g = RtoDNet(c.model)
    g.load_state_dict(g_sd)
    g = g.to(torch.device("cuda", torch.cuda.current_device()))
    h, w = c.model.image_size
    reset_counts()
    res = evaluate(c, make_eval_forward(c, g), SyntheticEvalDataset(n, h, w), verbose=False,
                   mesh=mesh, device=torch.device("cuda", torch.cuda.current_device()))
    return {"metrics": res, "launches": read_counts()}


def p27_cache(cfg, mesh):
    """(f): the sharded device cache over ``mesh`` on phase 22's corpus
    (through a decode cache of this rank's own: a cache directory is held
    by one process), on the card and on the CPU: the index streams, and
    this rank's rows of the first batches."""
    from gdn_tpu_torch.data.device_cache import ShardedDeviceDataset
    from gdn_tpu_torch.data.kitti import KittiTrainDataset
    from gdn_tpu_torch.parallel.multihost import rank

    kitti = os.path.join(OUT, "disk", "kitti")
    cache = os.path.join(OUT, "p27", f"decode_cache_rank{rank()}")
    out = {}
    for dev in ("cuda", "cpu"):
        ds = ShardedDeviceDataset(KittiTrainDataset(kitti, "train.txt", cfg.model.image_size,
                                                    TRAIN_BATCH, loop=False, seed=7,
                                                    cache_dir=cache), mesh,
                                  device=torch.device(dev, torch.cuda.current_device())
                                  if dev == "cuda" else dev)
        stream = [i.tolist() for i in ds._index_iter()]
        rows = [{k: v.cpu() for k, v in b.items()}
                for _, b in zip(range(P27_CACHE_BATCHES), ds)]
        out[dev] = {"stream": stream, "rows": rows, "resident_bytes": ds.resident_bytes}
    return out


def p27_nccl(out_dir, weights):
    """(d): one rank over NCCL (world size 1): a stage-1 step through
    the data-parallel path (the state placed, the gradients all-reduced
    over the group) against the plain step, from the same weights and
    batch, cuDNN deterministic: gradients and terms bit for bit."""
    sys.path.insert(0, ROOT)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    from gdn_tpu_torch import kernels as port_kernels
    from gdn_tpu_torch.config import kitti_config
    from gdn_tpu_torch.models import DtoDNet
    from gdn_tpu_torch.parallel.mesh import create_mesh, shard_state
    from gdn_tpu_torch.train.state import TrainState
    from gdn_tpu_torch.train.steps import make_stage1_step

    port_kernels.load_all()
    cfg = kitti_config(**{"model.use_pallas_gn": True})
    mesh = create_mesh(0, device_type="cuda")
    d_sd = torch.load(weights, weights_only=True)["d"]
    batch = {k: v.cuda() for k, v in p27_batches(cfg, 1)[0].items()}
    res = {"backend": torch.distributed.get_backend()}
    for name, m in (("plain", None), ("dp", mesh)):
        net = DtoDNet(cfg.model)
        net.load_state_dict(d_sd)
        state = TrainState(net.cuda(), cfg.train, 10)
        kw = {}
        if m is not None:
            state, specs = shard_state(state, m, "replicated")
            kw = dict(mesh=m, state_sharding=specs)
        grads = {}
        _first_grads(state, grads)
        reset_counts()
        _, terms = make_stage1_step(cfg, **kw)(state, batch)
        torch.cuda.synchronize()
        res[name] = {"grads": grads, "terms": {k: float(v) for k, v in terms.items()},
                     "launches": read_counts()}
    torch.save(res, os.path.join(out_dir, "nccl.pt"))


def _grad_gap(got, want):
    """max over tensors of max|got - want| / max|want|."""
    worst = 0.0
    for k, w in want.items():
        scale = w.abs().max().item() or 1.0
        worst = max(worst, (got[k] - w).abs().max().item() / scale)
    return worst


def _terms_gap(got, want):
    """(the first step's, every step's) largest relative difference of
    the loss terms."""
    gaps = [max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-12) for k in w)
            for g, w in zip(got, want)]
    return gaps[0], max(gaps)


def _terms_problem(what, gaps):
    """The first step's terms come from the same weights: phase 9's fp32
    rtol 1e-4.  Later steps follow bf16 Adam updates, where a gradient
    near zero may flip sign between two summation orders (ROADMAP's
    parity notes): 1e-3, within phase 9's 5% bf16 bound."""
    first, every = gaps
    if first > 1e-4 or every > 1e-3:
        return (f"{what} terms: first step {first:.3g} (bound 1e-4), every step "
                f"{every:.3g} (bound 1e-3)")
    return None


def phase_parallel(cfg):
    """Phase 27: data parallel and FSDP (see the module docstring).
    ``cfg``: phase 8's configuration."""
    from gdn_tpu_torch.config import _with
    from gdn_tpu_torch.parallel.multihost import run_ranks

    t0 = time.perf_counter()
    out, launches = {"device": smi_line()}, {}
    log(f"  {out['device']}")
    d_sd, g_sd = _p27_weights(cfg)
    work = os.path.join(OUT, "p27")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    weights = os.path.join(work, "weights.pt")
    torch.save({"d": d_sd, "g": g_sd}, weights)
    batches = p27_batches(cfg)
    valid = [float(batches[0]["mask"][i * 16:(i + 1) * 16].sum()) for i in (0, 1)]
    log(f"  valid pixels of the first batch: rank 0's rows {valid[0]:.0f}, rank 1's "
        f"{valid[1]:.0f} ({valid[1] / valid[0]:.2f}x)")
    if valid[1] < 2 * valid[0]:
        raise AssertionError(f"the ranks' valid counts differ by less than 2x: {valid}")

    single = p27_train(cfg, d_sd, g_sd, batches, None, "single")
    single32 = p27_train(_with(cfg, **{"model.dtype": "float32"}), d_sd, g_sd, batches[:1],
                         None, "single32", profile=False)  # stage 1 for phase 28
    fused_single = {tag: p27_train(_with(cfg, **over), d_sd, g_sd, batches[:1], None,
                                   f"{tag}_single", stages=(2,), profile=False)
                    for tag, over in P27_FUSED}
    eval_single = p27_eval(cfg, g_sd, None)
    launches["parallel_single32"] = single32["stage2"]["launches"]
    for stage in (1, 2):
        launches[f"parallel_single_stage{stage}"] = single[f"stage{stage}"]["launches"]
    for tag in fused_single:
        launches[f"parallel_single_{tag}"] = fused_single[tag]["stage2"]["launches"]
    launches["parallel_single_eval"] = eval_single["launches"]

    ts = time.perf_counter()
    run_ranks(p27_rank, P27_RANKS, (work, weights), device_type="cuda", timeout=600)
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(P27_RANKS)]
    out["ranks_seconds"] = time.perf_counter() - ts
    tn = time.perf_counter()
    run_ranks(p27_nccl, 1, (work, weights), device_type="cuda", timeout=300)
    nccl = torch.load(os.path.join(work, "nccl.pt"), weights_only=False)
    out["nccl_seconds"] = time.perf_counter() - tn

    problems = []
    # (a) data parallel: launches, terms, gradients, time
    out["dp"] = {}
    for stage in (1, 2):
        key = f"stage{stage}"
        one = single[key]
        row = {"single_ms_per_step": one["ms_per_step"],
               "single_profile": one.get("profile"), "ranks": []}
        for rk in ranks:
            rec = rk["dp"][key]
            launches[f"parallel_dp_rank{rk['rank']}_{key}"] = rec["launches"]
            row["ranks"].append({"rank": rk["rank"], "backend": rk["backend"],
                                 "ms_per_step": rec["ms_per_step"],
                                 "profile": rec.get("profile"),
                                 "launches": {k: v for k, v in rec["launches"].items() if v}})
            if rec["launches"] != one["launches"]:
                problems.append(f"(a) {key} rank {rk['rank']} launches {rec['launches']} "
                                f"!= one process's {one['launches']}")
            for k in ("group_norm_elu", "fused_loss_fwd", "fused_loss_bwd"):
                if rec["launches"][k] < 1:
                    problems.append(f"(a) {key} rank {rk['rank']}: {k} not launched")
        r0 = ranks[0]["dp"][key]
        row["terms_rel_gap"] = _terms_gap(r0["terms"], one["terms"])
        row["grad_rel_gap"] = _grad_gap(r0["grads"], one["grads"])
        row["terms"] = {"dp": r0["terms"], "single": one["terms"]}
        problems.append(_terms_problem(f"(a) {key}", row["terms_rel_gap"]))
        if row["grad_rel_gap"] > BF16_GRAD_TOL:
            problems.append(f"(a) {key} bf16 gradients beyond {BF16_GRAD_TOL} of their "
                            f"largest: {row['grad_rel_gap']:.3g}")
        out["dp"][key] = row
        log(f"  (a) DP {key}: terms max rel gap {row['terms_rel_gap'][0]:.3g} at step 1, "
            f"{row['terms_rel_gap'][1]:.3g} over {P27_STEPS} steps, first-step "
            f"gradients {row['grad_rel_gap']:.3g} of each tensor's largest; ms/step "
            f"(host clock, steps 2-{P27_STEPS}): one process {one['ms_per_step']:.1f}, "
            + ", ".join(f"rank {x['rank']} {x['ms_per_step']:.1f}" for x in row["ranks"]))
        if stage == 2:
            for who, prof in [("one process", one.get("profile"))] + [
                    (f"rank {x['rank']}", x["profile"]) for x in row["ranks"]]:
                log(f"      profiled stage-2 step, {who}: " + (
                    f"wall {prof['wall_ms']:.1f} ms, busy {prof['device_busy_ms']:.2f} ms "
                    f"(idle {prof['idle_share']:.1%}), {prof['kernel_launches']} kernel "
                    f"launches, kernels 1-3 {prof['calls']}" if prof else "not measured"))
                if prof and min(prof["calls"].values()) < 1:
                    problems.append(f"(a) {who}'s profiler recorded no launch of a kernel "
                                    f"of 1-3: {prof['calls']}")
    # (a), fp32: one stage-2 step at phase 9's fp32 bounds
    one32 = single32["stage2"]
    fp32 = {"terms_rel_gap": _terms_gap(ranks[0]["dp32"]["stage2"]["terms"],
                                        one32["terms"])[0],
            "grad_rel_gap": _grad_gap(ranks[0]["dp32"]["stage2"]["grads"], one32["grads"])}
    for rk in ranks:
        launches[f"parallel_dp32_rank{rk['rank']}"] = rk["dp32"]["stage2"]["launches"]
    out["dp"]["stage2_fp32"] = fp32
    if fp32["terms_rel_gap"] > 1e-4 or fp32["grad_rel_gap"] > 1e-3:
        problems.append(f"(a) fp32 stage-2 step: terms {fp32['terms_rel_gap']:.3g} (bound "
                        f"1e-4), gradients {fp32['grad_rel_gap']:.3g} (bound 1e-3)")
    log(f"  (a) DP stage-2 step in fp32 (TF32 off): terms max rel gap "
        f"{fp32['terms_rel_gap']:.3g}, gradients {fp32['grad_rel_gap']:.3g} of each "
        "tensor's largest")
    # (b) FSDP
    fsdp_runs = [(rk["rank"], rk["fsdp"]["stage2"]) for rk in ranks]
    one = single["stage2"]
    fs = {"backend": ranks[0]["backend"], "single_bytes": one["bytes"], "per_rank": []}
    for r, rec in fsdp_runs:
        launches[f"parallel_fsdp_rank{r}"] = rec["launches"]
        fs["per_rank"].append({"rank": r, "bytes": rec["bytes"],
                               "param_share": rec["bytes"][0] / one["bytes"][0],
                               "optimizer_share": rec["bytes"][1] / one["bytes"][1],
                               "ms_per_step": rec["ms_per_step"]})
        if rec["launches"] != one["launches"]:
            problems.append(f"(b) rank {r} launches {rec['launches']} != {one['launches']}")
    r0 = fsdp_runs[0][1]
    fs["terms_rel_gap"] = _terms_gap(r0["terms"], one["terms"])
    fs["grad_rel_gap"] = _grad_gap(r0["grads"], one["grads"])
    problems.append(_terms_problem("(b) FSDP", fs["terms_rel_gap"]))
    if fs["grad_rel_gap"] > BF16_GRAD_TOL:
        problems.append(f"(b) FSDP bf16 gradients {fs['grad_rel_gap']:.3g} beyond "
                        f"{BF16_GRAD_TOL} of their largest")
    for x in fs["per_rank"]:
        if not (0.45 < x["param_share"] < 0.55 and 0.45 < x["optimizer_share"] < 0.55):
            problems.append(f"(b) rank {x['rank']} holds {x['param_share']:.3f} of the "
                            f"parameter and {x['optimizer_share']:.3f} of the optimizer "
                            "bytes, not about half")
    out["fsdp"] = fs
    log(f"  (b) FSDP over {P27_RANKS} ranks ({fs['backend']}): terms max rel gap "
        f"{fs['terms_rel_gap'][0]:.3g} at step 1, {fs['terms_rel_gap'][1]:.3g} over "
        f"{P27_STEPS}, gradients {fs['grad_rel_gap']:.3g}; " + ", ".join(
            f"rank {x['rank']} holds {x['bytes'][0] / 2**20:.2f} MiB of parameters "
            f"({x['param_share']:.3f}) and {x['bytes'][1] / 2**20:.2f} MiB of Adam moments "
            f"({x['optimizer_share']:.3f}), {x['ms_per_step']:.1f} ms/step"
            for x in fs["per_rank"])
        + f" (one process {one['bytes'][0] / 2**20:.2f} / {one['bytes'][1] / 2**20:.2f} MiB)")
    # (c) the fused configurations' step inside the ranks
    out["fused"] = {}
    for tag, _ in P27_FUSED:
        want = fused_single[tag]["stage2"]["launches"]
        got = [rk["fused"][tag]["stage2"]["launches"] for rk in ranks]
        for rk, g in zip(ranks, got):
            launches[f"parallel_{tag}_rank{rk['rank']}"] = g
            if g != want:
                problems.append(f"(c) {tag} rank {rk['rank']} launches {g} != {want}")
        gap = _terms_gap(ranks[0]["fused"][tag]["stage2"]["terms"],
                         fused_single[tag]["stage2"]["terms"])
        out["fused"][tag] = {"launches": {k: v for k, v in want.items() if v},
                             "terms_rel_gap": gap[0]}
        problems.append(_terms_problem(f"(c) {tag}", gap))
        log(f"  (c) {tag}: one DP step, launches a rank "
            f"{ {k: v for k, v in got[0].items() if v} }, terms max rel gap {gap[0]:.3g}")
    for k in FUSED_COUNTERS:
        if not any(rk["fused"][t]["stage2"]["launches"][k] for rk in ranks
                   for t, _ in P27_FUSED):
            problems.append(f"(c) {k} launched in no rank")
    # (d) world size 1 over NCCL
    same = (nccl["dp"]["terms"] == nccl["plain"]["terms"]
            and all(torch.equal(nccl["dp"]["grads"][k], v)
                    for k, v in nccl["plain"]["grads"].items()))
    launches["parallel_nccl_plain"] = nccl["plain"]["launches"]
    launches["parallel_nccl_dp"] = nccl["dp"]["launches"]
    out["nccl"] = {"backend": nccl["backend"], "bit_identical": same}
    if nccl["backend"] != "nccl" or not same:
        problems.append(f"(d) {nccl['backend']}: DP gradients not bit-identical to the "
                        "plain step's")
    log(f"  (d) world size 1 over {nccl['backend']}: DP step's gradients and terms "
        f"{'bit-identical to' if same else 'DIFFER from'} the plain step's")
    # (e) DP eval
    want = eval_single["metrics"]
    gaps = {}
    for rk in ranks:
        got = rk["eval"]["metrics"]
        launches[f"parallel_eval_rank{rk['rank']}"] = rk["eval"]["launches"]
        for k in ("abs_rel", "sq_rel", "rmse", "rmse_log", "log10", "a1", "a2", "a3"):
            gaps[k] = max(gaps.get(k, 0.0), abs(got[k] - want[k]))
    from gdn_tpu_torch.data.synthetic import SyntheticEvalDataset
    from gdn_tpu_torch.metrics import crop_mask

    h, w = cfg.model.image_size
    one_pixel = 1.0 / min(  # of the sparsest image: valid GT within the cap and crop
        int(((s["gt"][0] > cfg.model.min_depth) & (s["gt"][0] < cfg.eval.cap)
             & crop_mask(h, w, cfg.eval.crop)).sum())
        for s in SyntheticEvalDataset(P27_EVAL[0], h, w))
    out["eval"] = {"abs_gaps": gaps, "single": want,
                   "ranks": [rk["eval"]["metrics"] for rk in ranks]}
    for k, g in gaps.items():
        if g > (max(1e-5, one_pixel) if k.startswith("a") and k[1:].isdigit()
                else 1e-5 * max(1.0, abs(want[k]))):
            problems.append(f"(e) DP eval {k} differs by {g:.3g}")
    log(f"  (e) DP eval of {P27_EVAL[0]} synthetic images, batch {P27_EVAL[1]}, fp32: max "
        "|rank - one process| " + ", ".join(f"{k} {v:.2g}" for k, v in gaps.items()))
    # (f) the sharded device cache
    streams_equal = all(rk["cache"]["cuda"]["stream"] == rk["cache"]["cpu"]["stream"]
                        == ranks[0]["cache"]["cpu"]["stream"] for rk in ranks)
    rows_equal = all(torch.equal(a[k], b[k]) for rk in ranks
                     for a, b in zip(rk["cache"]["cuda"]["rows"], rk["cache"]["cpu"]["rows"])
                     for k in a)
    out["cache"] = {"streams_equal": streams_equal, "rows_equal": rows_equal,
                    "batches": len(ranks[0]["cache"]["cpu"]["stream"]),
                    "resident_bytes_a_rank": ranks[0]["cache"]["cuda"]["resident_bytes"]}
    if not (streams_equal and rows_equal):
        problems.append(f"(f) sharded cache: streams equal {streams_equal}, rows equal "
                        f"{rows_equal}")
    log(f"  (f) sharded device cache over {P27_RANKS} ranks: "
        f"{out['cache']['batches']} batches, index streams card = CPU port: "
        f"{streams_equal}, rows of {P27_CACHE_BATCHES} batches equal: {rows_equal}, "
        f"{out['cache']['resident_bytes_a_rank'] / 2**20:.1f} MiB resident a rank")
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 27 took {out['seconds']:.1f} s (ranks {out['ranks_seconds']:.1f} s, "
        f"NCCL rank {out['nccl_seconds']:.1f} s)")
    problems = [p for p in problems if p]
    if problems:
        raise AssertionError("phase 27: " + "; ".join(problems))
    return out, launches, {"single": single, "single32": single32,
                           "fused_single": fused_single}


P28_RANKS = 2  # ranks sharing the one card over gloo
BF16_TERMS_TOL = 0.05  # phase 9's bf16 bound: a rank's convs round in other places
# (c): the loss without its multi-scale gradient term.  Its coarse scales
# keep only pixels whose four children are valid (a few at these masks'
# densities), each weighing 1/count: where bf16 moves the prediction, the
# sign of such a pixel's difference flips and moves a tensor's gradient by
# tens of percent in one process as in the ranks (measured on the H100).
# The SP bf16 gradients are held to one process without it; with it, the
# fp32 step holds them.
NO_GRAD_TERM = {"loss.w_grad": 0.0}
P28_TALL = (8, 512, 416)  # (d): batch and image size of the tall image
P28_MEM_SHARE = 0.65  # (d): a spatial rank's peak activations against one process's
P28_PROFILED = (("group_norm_elu", "gn_elu_coop"), ("group_norm_elu_rows", "gn_rows_"),
                ("fused_loss_fwd", "loss_forward"), ("fused_loss_bwd", "loss_backward"))


def _gn_channels(record):
    """Record the channels of every launch of the one-launch GN+ELU
    kernel in ``record`` (both its autograd and its registered-op route
    call ``groupnorm._launch``)."""
    from gdn_tpu_torch.kernels import groupnorm as gnk

    launch = gnk._launch

    def recorded(x, *args):
        record.append(int(x.shape[1]))
        return launch(x, *args)

    gnk._launch = recorded


def p28_tall(cfg, d_sd, g_sd, mesh):
    """(d): one stage-2 step at P28_TALL, its peak allocated memory above
    the placed state (this process's allocator), and its terms."""
    from gdn_tpu_torch.config import _with
    from gdn_tpu_torch.models import DtoDNet, RtoDNet
    from gdn_tpu_torch.parallel.mesh import param_mode, shard_batch, shard_frozen, shard_state
    from gdn_tpu_torch.train.state import TrainState
    from gdn_tpu_torch.train.steps import make_stage2_step

    b, h, w = P28_TALL
    dev = torch.device("cuda", torch.cuda.current_device())
    c = _with(cfg, **{"model.image_size": (h, w)})
    g = RtoDNet(c.model)
    g.load_state_dict(g_sd)
    state = TrainState(g.to(dev), c.train, 10, freeze_decoder=True)
    state, specs = shard_state(state, mesh, param_mode(c.mesh))
    d = DtoDNet(c.model)
    d.load_state_dict(d_sd)
    d = shard_frozen(d.to(dev).requires_grad_(False), mesh, param_mode(c.mesh))
    rng = np.random.default_rng(28)
    batch = {"depth": torch.from_numpy(rng.uniform(1, 79, (b, h, w, 1)).astype(np.float32)),
             "mask": torch.from_numpy((rng.random((b, h, w, 1)) < 0.3).astype(np.float32)),
             "rgb": torch.from_numpy(rng.random((b, h, w, 3)).astype(np.float32))}
    batch = {k: v.to(dev) for k, v in shard_batch(batch, mesh).items()}
    step = make_stage2_step(c, **({} if mesh is None else dict(mesh=mesh,
                                                               state_sharding=specs)))
    step(state, d, batch)  # the allocator's and cuDNN's first-use costs
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, terms = step(state, d, batch)
    torch.cuda.synchronize()
    return {"peak_above_state": torch.cuda.max_memory_allocated() - base,
            "state": base, "terms": {k: float(v) for k, v in terms.items()}}


def p28_rank(out_dir, weights):
    """The ranks of phase 28 (a)-(d): every result into
    ``out_dir/rank<r>.pt``."""
    sys.path.insert(0, ROOT)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from gdn_tpu_torch import kernels as port_kernels
    from gdn_tpu_torch.config import _with, kitti_config
    from gdn_tpu_torch.parallel import multihost
    from gdn_tpu_torch.parallel.mesh import create_mesh

    port_kernels.load_all()  # built by the parent: loads
    r = multihost.rank()
    cfg = kitti_config(**{"model.use_pallas_gn": True})
    tp, sp = (_with(cfg, **{f"mesh.{k}_devices": 2}) for k in ("model", "spatial"))
    cols = create_mesh(0, model=2, device_type="cuda")
    rows = create_mesh(0, spatial=2, device_type="cuda")
    d_sd, g_sd = torch.load(weights, weights_only=True).values()
    batches = p27_batches(cfg)
    res = {"rank": r, "backend": torch.distributed.get_backend()}
    channels = []
    _gn_channels(channels)
    res["tp"] = p27_train(tp, d_sd, g_sd, batches, cols, f"tp_rank{r}", record=channels)
    res["tp32"] = p27_train(_with(tp, **{"model.dtype": "float32"}), d_sd, g_sd, batches[:1],
                            cols, f"tp32_rank{r}", profile=False)
    res["tp_fused"] = {tag: p27_train(_with(tp, **over), d_sd, g_sd, batches[:1], cols,
                                      f"tp_{tag}_rank{r}", stages=(2,), profile=False)
                       for tag, over in P27_FUSED}
    res["sp"] = p27_train(sp, d_sd, g_sd, batches, rows, f"sp_rank{r}", record=channels)
    res["sp32"] = p27_train(_with(sp, **{"model.dtype": "float32"}), d_sd, g_sd, batches[:1],
                            rows, f"sp32_rank{r}", profile=False)
    res["sp_nograd"] = p27_train(_with(sp, **NO_GRAD_TERM), d_sd, g_sd, batches[:1], rows,
                                 f"sp_nograd_rank{r}", profile=False)
    res["tall"] = p28_tall(sp, d_sd, g_sd, rows)
    torch.save(res, os.path.join(out_dir, f"rank{r}.pt"))


def p28_split_gn(cfg):
    """The split GN+ELU kernel (on a spatial axis of extent 1: both
    launches, no collective) against its plain version and the plain
    fp32 statistics, at every site shape a spatial rank of the B=32
    128x416 nets holds; with the kernel's and the plain version's device
    times and the bound."""
    from gdn_tpu_torch.kernels import groupnorm as gnk
    from gdn_tpu_torch.ops.groupnorm import (
        _chanreduce_stats, group_norm_elu_plain, pick_groups,
    )
    from gdn_tpu_torch.parallel.mesh import Axis

    alone = Axis(None, 1, 0)
    rows, gen = [], torch.Generator(device="cuda").manual_seed(28)
    sites = [(c, h // 2, w) for c, h, w in gn_sites(cfg.model)]
    for c, h, w in sorted(set(sites), reverse=True):
        g = pick_groups(c, cfg.model.group_norm_groups)
        shape = (TRAIN_BATCH, c, h, w)
        x = _gn_input(shape, torch.bfloat16, gen)
        scale = torch.rand(c, device="cuda", generator=gen) + 0.5
        bias = torch.randn(c, device="cuda", generator=gen)
        what = f"group_norm_elu_rows {shape} bf16"
        out, stats = split_gn_twice(x, scale, bias, g, alone, h, what)
        err = check_close(out, group_norm_elu_plain(x, scale, bias, g), x.dtype, what)
        mean_c, inv_c = _chanreduce_stats(x, g, 1e-6)
        cg = c // g
        serr = check_tol(stats, torch.stack([mean_c[:, ::cg], inv_c[:, ::cg]], 1), 1e-5,
                         1e-6, f"{what} statistics")
        row = {"B": TRAIN_BATCH, "C": c, "H": h, "W": w, "groups": g,
               "sites": sites.count((c, h, w)), "max_abs_err": err,
               "stats_max_abs_err": serr, "split_ms": {},
               "plan": gnk.rows_plan_for(x, g)._asdict(),
               "bound_ms": bound_ms(*gn_work(shape, x.element_size()))}
        row["ms"] = device_ms([lambda: gnk._launch_rows(x, scale, bias, g, 1e-6, alone, h)],
                              what=what, split=row["split_ms"])
        check_split_kernels(row["split_ms"], what)
        check_split_call(lambda: gnk._launch_rows(x, scale, bias, g, 1e-6, alone, h), what)
        row["plain_ms"] = device_ms([lambda: group_norm_elu_plain(x, scale, bias, g)],
                                    what=f"{what} plain")
        sc, bi = scale.to(x.dtype), bias.to(x.dtype)  # on one rank, the same function
        row["library_ms"] = device_ms([lambda: F.elu(F.group_norm(x, g, sc, bi, 1e-6))],
                                      what=f"{what} library")
        rows.append(row)
        log(f"  {what}: max|k-p| {err:.3g}, stats {serr:.3g}; device us: kernel "
            f"{row['ms'] * 1e3:.1f} ({split_text(row['split_ms'])}), plain "
            f"{row['plain_ms'] * 1e3:.1f}, library {row['library_ms'] * 1e3:.1f}, bound "
            f"{row['bound_ms'] * 1e3:.1f} "
            f"({row['bound_ms'] / row['ms']:.0%} of it reached)  x{row['sites']} sites; "
            f"plan {row['plan']}")
        del x
    return rows


SPLIT_KERNELS = ("gn_rows_sums", "gn_rows_apply")  # a split call's two kernels


def split_gn_twice(x, scale, bias, g, ax, rows, what):
    """Two calls of the split GN+ELU kernel on the same input -> the
    first's (out, stats); raises unless both gave the same bits."""
    from gdn_tpu_torch.kernels import groupnorm as gnk

    out, stats = gnk._launch_rows(x, scale, bias, g, 1e-6, ax, rows)
    again, stats2 = gnk._launch_rows(x, scale, bias, g, 1e-6, ax, rows)
    torch.cuda.synchronize()
    if not (torch.equal(out, again) and torch.equal(stats, stats2)):
        raise AssertionError(f"{what}: two calls on the same input differ")
    return out, stats


ALLOC_OPS = ("aten.empty", "aten.detach", "aten.zeros")  # what a split call may dispatch


def split_call_ops(call):
    """(the C entry points launched, the torch ops dispatched) of
    ``call()``, one call of the split form: each entry point launches one
    kernel, and a TorchDispatchMode sees every op torch runs besides.
    No profiler: late in a long process CUPTI has recorded no kernel."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from gdn_tpu_torch.kernels import groupnorm as gnk

    lib, launched, ops = gnk.load(), [], []
    entries = {name: getattr(lib, name) for name in SPLIT_KERNELS}

    def counted(name, fn):
        def launch(*args):
            launched.append(name)
            return fn(*args)
        return launch

    class Seen(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(str(func))
            return func(*args, **(kwargs or {}))

    try:
        for name, fn in entries.items():
            setattr(lib, name, counted(name, fn))
        with Seen():
            call()
    finally:
        for name, fn in entries.items():
            setattr(lib, name, fn)
    return launched, ops


def check_split_call(call, what):
    """One call launched gn_rows_sums then gn_rows_apply and ran no torch
    op but allocations (the fold is in gn_rows_sums: no reduce)."""
    launched, ops = split_call_ops(call)
    other = [op for op in ops if not op.startswith(ALLOC_OPS)]
    if launched != list(SPLIT_KERNELS) or other:
        raise AssertionError(f"{what}: a call launched {launched} and ran {other}")
    return ops


def check_split_kernels(split, what):
    """A call of the split form ran its two kernels and nothing else on
    the card (the fold is in gn_rows_sums: no torch reduce between them).
    Where the profiler came back short, device_ms timed with events and
    ``split`` is empty: nothing to read."""
    if not split:
        return
    names = [k for k in split if k != "launches"]
    bad = [k for k in names if not any(n in k for n in SPLIT_KERNELS)]
    if split.get("launches") != 2 or bad or len(names) != 2:
        raise AssertionError(f"{what}: a call should launch gn_rows_sums and gn_rows_apply "
                             f"alone, got {split}")


def phase_tp_sp(cfg, refs):
    """Phase 28: tensor and spatial parallelism (see the module
    docstring).  ``refs``: phase 27's one-process runs on the same
    weights and batches."""
    from gdn_tpu_torch.parallel.multihost import run_ranks

    t0 = time.perf_counter()
    out, launches, problems = {"device": smi_line()}, {}, []
    log(f"  {out['device']}")
    work = os.path.join(OUT, "p28")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    weights = os.path.join(work, "weights.pt")
    d_sd, g_sd = _p27_weights(cfg)
    torch.save({"d": d_sd, "g": g_sd}, weights)
    log("  the split GN+ELU kernel vs plain, a spatial rank's shapes (B=32, half the rows)")
    out["split_gn"] = p28_split_gn(cfg)
    from gdn_tpu_torch.config import _with

    refs = {**refs, "single_nograd": p27_train(
        _with(cfg, **NO_GRAD_TERM), d_sd, g_sd, p27_batches(cfg)[:1], None, "single_nograd",
        profile=False)}
    reset_counts()
    tall = p28_tall(cfg, d_sd, g_sd, None)
    launches["tp_sp_tall_single"] = read_counts()

    ts = time.perf_counter()
    run_ranks(p28_rank, P28_RANKS, (work, weights), device_type="cuda", timeout=900)
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(P28_RANKS)]
    out["ranks_seconds"] = time.perf_counter() - ts
    single, single32, fused_single = refs["single"], refs["single32"], refs["fused_single"]
    site_c = [c for c, _, _ in gn_sites(cfg.model)]

    def held(tag, got, want, grads=True):
        """bf16 against one process: the terms of every step within phase
        9's bf16 bound and, where ``grads``, the first update's gradients
        within it of each tensor's largest, as phase 27 holds DP."""
        row = {"terms_rel_gap": _terms_gap(got["terms"], want["terms"]),
               "grad_rel_gap": _grad_gap(got["grads"], want["grads"])}
        if max(row["terms_rel_gap"]) > BF16_TERMS_TOL:
            problems.append(f"{tag} bf16 terms {max(row['terms_rel_gap']):.3g} beyond "
                            f"{BF16_TERMS_TOL}")
        if grads and row["grad_rel_gap"] > BF16_GRAD_TOL:
            problems.append(f"{tag} bf16 gradients {row['grad_rel_gap']:.3g} beyond "
                            f"{BF16_GRAD_TOL} of their largest")
        return row

    def fp32_gap(tag, got, want):
        row = {"terms_rel_gap": _terms_gap(got["terms"], want["terms"])[0],
               "grad_rel_gap": _grad_gap(got["grads"], want["grads"])}
        if row["terms_rel_gap"] > 1e-4 or row["grad_rel_gap"] > 1e-3:
            problems.append(f"{tag} fp32: terms {row['terms_rel_gap']:.3g} (bound 1e-4), "
                            f"gradients {row['grad_rel_gap']:.3g} (bound 1e-3)")
        return row

    # (a) TP and (c) SP: both stages against one process, in bf16 and fp32
    for mode, letter in (("tp", "a"), ("sp", "c")):
        out[mode] = {}
        for stage in (1, 2):
            key = f"stage{stage}"
            one = single[key]
            tag = f"({letter}) {mode} {key}"
            row = {**held(tag, ranks[0][mode][key], one, grads=mode == "tp"),
                   "single_ms_per_step": one["ms_per_step"], "ranks": []}
            row["fp32"] = fp32_gap(tag, ranks[0][f"{mode}32"][key], single32[key])
            if mode == "sp":
                row["no_grad_term"] = held(f"{tag} without the gradient term",
                                           ranks[0]["sp_nograd"][key],
                                           refs["single_nograd"][key])
            gn_per_step = (1 if stage == 1 else 2) * len(site_c)
            for rk in ranks:
                rec = rk[mode][key]
                launches[f"tp_sp_{mode}_rank{rk['rank']}_{key}"] = rec["launches"]
                launches[f"tp_sp_{mode}32_rank{rk['rank']}_{key}"] = (
                    rk[f"{mode}32"][key]["launches"])
                row["ranks"].append({"rank": rk["rank"], "ms_per_step": rec["ms_per_step"],
                                     "profile": rec.get("profile"), "bytes": rec["bytes"],
                                     "launches": {k: v for k, v in rec["launches"].items()
                                                  if v}})
                got = rec["launches"]
                if mode == "tp":
                    want = one["launches"]
                    if got != want:
                        problems.append(f"(a) {key} rank {rk['rank']} launches {got} != "
                                        f"one process's {want}")
                    halves = sorted(c // 2 for c in site_c * (got["group_norm_elu"]
                                                              // len(site_c)))
                    if sorted(rec["recorded"]) != halves:
                        problems.append(f"(a) {key} rank {rk['rank']}: the GN+ELU kernel ran "
                                        "on other than half of each site's channels")
                    if got["fused_loss_fwd"] != P27_STEPS or got["fused_loss_bwd"] != P27_STEPS:
                        problems.append(f"(a) {key} rank {rk['rank']}: loss kernels {got}")
                    share = [rec["bytes"][i] / one["bytes"][i] for i in (0, 1)]
                    row["ranks"][-1]["shares"] = share
                    if not all(0.45 < x < 0.55 for x in share):
                        problems.append(f"(a) {key} rank {rk['rank']} holds {share} of the "
                                        "parameter and Adam bytes, not about half")
                else:
                    want = {k: 0 for k in COUNTERS}
                    want["group_norm_elu_rows"] = gn_per_step * P27_STEPS
                    if got != want:
                        problems.append(f"(c) {key} rank {rk['rank']} launches {got}, "
                                        f"expected {want}")
            out[mode][key] = row
            log(f"  ({letter}) {mode.upper()} {key}: bf16 terms max rel gap "
                f"{row['terms_rel_gap'][0]:.3g} at step 1, {row['terms_rel_gap'][1]:.3g} "
                f"over {P27_STEPS} steps, first-step gradients {row['grad_rel_gap']:.3g} of "
                f"each tensor's largest" + (
                    f" ({row['no_grad_term']['grad_rel_gap']:.3g} without the gradient "
                    "term)" if mode == "sp" else "")
                + f"; the fp32 step: terms {row['fp32']['terms_rel_gap']:.3g}, gradients "
                f"{row['fp32']['grad_rel_gap']:.3g}")
            log(f"      ms/step (host clock, steps 2-{P27_STEPS}): one process "
                f"{one['ms_per_step']:.1f}, " + ", ".join(
                    f"rank {x['rank']} {x['ms_per_step']:.1f}" for x in row["ranks"])
                + "; launches a rank: " + str(row["ranks"][0]["launches"]) + (
                    "; shares of the parameter / Adam bytes: " + ", ".join(
                        f"rank {x['rank']} {x['shares'][0]:.3f} / {x['shares'][1]:.3f}"
                        for x in row["ranks"]) if mode == "tp" else ""))
            if stage == 2:
                for x in row["ranks"]:
                    prof = x["profile"]
                    log(f"      profiled stage-2 step, rank {x['rank']}: " + (
                        f"wall {prof['wall_ms']:.1f} ms, busy {prof['device_busy_ms']:.2f} "
                        f"ms (idle {prof['idle_share']:.1%}), {prof['kernel_launches']} "
                        f"kernel launches" if prof else "not measured"))
    # (b) TP with the fused conv kernels
    out["tp_fused"] = {}
    for tag, _ in P27_FUSED:
        gap = _terms_gap(ranks[0]["tp_fused"][tag]["stage2"]["terms"],
                         fused_single[tag]["stage2"]["terms"])
        if gap[0] > BF16_TERMS_TOL:
            problems.append(f"(b) {tag} bf16 terms {gap[0]:.3g} beyond {BF16_TERMS_TOL}")
        got = [rk["tp_fused"][tag]["stage2"]["launches"] for rk in ranks]
        for rk, g in zip(ranks, got):
            launches[f"tp_sp_tp_{tag}_rank{rk['rank']}"] = g
        out["tp_fused"][tag] = {"terms_rel_gap": gap[0],
                                "launches": [{k: v for k, v in g.items() if v} for g in got]}
        log(f"  (b) TP {tag}: one stage-2 step, launches a rank "
            f"{ {k: v for k, v in got[0].items() if v} }, terms max rel gap {gap[0]:.3g}")
    for k in FUSED_COUNTERS:
        for rk in ranks:
            if not any(rk["tp_fused"][t]["stage2"]["launches"][k] for t, _ in P27_FUSED):
                problems.append(f"(b) {k} launched in no TP step of rank {rk['rank']}")
    # (d) the tall image under SP
    out["tall"] = {"single": tall, "ranks": [rk["tall"] for rk in ranks]}
    for rk in ranks:
        share = rk["tall"]["peak_above_state"] / tall["peak_above_state"]
        rk["tall"]["share"] = share
        if share >= P28_MEM_SHARE:
            problems.append(f"(d) rank {rk['rank']}'s peak activations {share:.3f} of one "
                            f"process's (bound {P28_MEM_SHARE})")
    gap = max(abs(ranks[0]["tall"]["terms"][k] - tall["terms"][k])
              / max(abs(tall["terms"][k]), 1e-12) for k in tall["terms"])
    out["tall"]["terms_rel_gap"] = gap
    if gap > BF16_TERMS_TOL:
        problems.append(f"(d) tall image terms {gap:.3g} from one process's (bound "
                        f"{BF16_TERMS_TOL})")
    b, h, w = P28_TALL
    log(f"  (d) SP stage-2 step at B={b}, {h}x{w}: peak allocated above the state, one "
        f"process {tall['peak_above_state'] / 2**30:.2f} GiB; " + ", ".join(
            f"rank {rk['rank']} {rk['tall']['peak_above_state'] / 2**30:.2f} GiB "
            f"({rk['tall']['share']:.3f})" for rk in ranks)
        + f"; terms max rel gap {gap:.3g}")
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 28 took {out['seconds']:.1f} s (ranks {out['ranks_seconds']:.1f} s)")
    problems = [p for p in problems if p]
    if problems:
        raise AssertionError("phase 28: " + "; ".join(problems))
    return out, launches


# --------------------------------------------------------------- phase 29

P29_BATCH = 8
P29_RANKS = 2  # (a), (b), (c) fused guidance under FSDP: ranks sharing the card
P29_FSDP_RANKS = 4  # (c): data 2 x spatial 2
# (a): the knob grid, (tag, ModelConfig fields, TrainConfig fields, stage):
# three variant nets that take every variant site between them, then
# stage 2's fused guidance (its hand-written backward) and paired encoders
P29_GRID = (
    ("deconv_add_ms_gelu", {"model.upsample": "deconv", "model.fusion": "add",
                            "model.multiscale_heads": True, "model.activation": "gelu"}, 1),
    ("none_relu", {"model.norm": "none", "model.activation": "relu"}, 1),
    ("deconv_gn", {"model.upsample": "deconv", "model.deconv_gn": True}, 1),
    ("fg", {"train.fused_guidance": True, "train.fused_guidance_vjp": True}, 2),
    ("fe", {"train.fused_guidance": True, "train.fused_encoders": True}, 2),
)
P29_AXES = (("tp", "mesh.model_devices"), ("sp", "mesh.spatial_devices"))
P29_NYU = (228, 304)  # (b): NYU's own size, levels 228 -> 114 -> 57 -> 29 -> 15 -> 8
P29_SCRIPT_STEPS = 2
# (d): train_torch.py under each axis with the default net (phase 28
# (e)'s commands, run here at once with these) and with a variant flag,
# the SP one at NYU's size
P29_SCRIPTS = (
    ("tp", ["--model_devices", "2"]),
    ("sp", ["--spatial_devices", "2"]),
    ("tp_deconv", ["--model_devices", "2", "--upsample", "deconv"]),
    ("sp_nyu_norm_none", ["--spatial_devices", "2", "--norm", "none", "--height",
                          str(P29_NYU[0]), "--width", str(P29_NYU[1]), "--max_depth", "10"]),
)
F32 = {"model.dtype": "float32"}
# (a)-(c) hold the fp32 step's gradients at 1e-3 of each tensor's
# largest and the bf16 step's terms at phase 28's 5%; the bf16 gradients
# at its 5% or, where larger, one process's own bf16-to-fp32 gap in the
# same call: at B=8 a tensor's bf16 gradients (GroupNorm scales and
# biases, the deep convs of norm="none") lie 3.7-14.3% of its largest
# from its fp32 ones in one process, and a rank's 2.3-9.1% from one
# process's bf16 ones (my chip runs, PR 19; PERF.md §6), so a rank's
# bf16 step may round as far from one process's as bf16 from fp32.

def p29_batch(cfg, seed=29):
    """One global batch of P29_BATCH at the config's size: continuous
    depth inside (0, max_depth), ~30% valid, RGB (numpy draws)."""
    h, w = cfg.model.image_size
    top = cfg.model.max_depth
    rng = np.random.default_rng(seed)
    shape = (P29_BATCH, h, w)
    return {"depth": torch.from_numpy(rng.uniform(0.05 * top, 0.95 * top, (*shape, 1))
                                      .astype(np.float32)),
            "mask": torch.from_numpy((rng.random((*shape, 1)) < 0.3).astype(np.float32)),
            "rgb": torch.from_numpy(rng.random((*shape, 3)).astype(np.float32))}


def p29_weights(cfg, seed):
    """(D-net, G-net with the D-net's decoder) state dicts of ``cfg``'s
    architecture, init_params draws of ``seed`` and ``seed + 1``."""
    from gdn_tpu_torch.checkpoint import init_params, transfer_stage1_decoder

    gen = torch.Generator()
    d_sd = init_params(cfg.model, gen.manual_seed(seed), in_channels=1)
    return d_sd, transfer_stage1_decoder(init_params(cfg.model, gen.manual_seed(seed + 1)),
                                         d_sd)


def p29_step(cfg, weights, batch, mesh, stage, steps=1):
    """``steps`` steps of ``stage`` from ``weights`` on the global
    ``batch`` (this rank's rows under ``mesh``, the state placed by
    ``cfg.mesh``): each step's terms, launches, row gathers and ms (host
    clock, synchronized), and the first update's whole gradients."""
    from gdn_tpu_torch.models import DtoDNet, RtoDNet
    from gdn_tpu_torch.parallel import spatial
    from gdn_tpu_torch.parallel.mesh import param_mode, shard_batch, shard_frozen, shard_state
    from gdn_tpu_torch.train.state import TrainState
    from gdn_tpu_torch.train.steps import make_stage1_step, make_stage2_step

    dev = torch.device("cuda", torch.cuda.current_device())
    d_sd, g_sd = weights
    net = (DtoDNet if stage == 1 else RtoDNet)(cfg.model)
    net.load_state_dict(d_sd if stage == 1 else g_sd)
    state = TrainState(net.to(dev), cfg.train, 10, freeze_decoder=stage == 2)
    state, specs = shard_state(state, mesh, param_mode(cfg.mesh))
    grads = {}
    _first_grads(state, grads)
    args = ()
    if stage == 2:
        d = DtoDNet(cfg.model)
        d.load_state_dict(d_sd)
        args = (shard_frozen(d.to(dev).requires_grad_(False), mesh, param_mode(cfg.mesh)),)
    make = make_stage1_step if stage == 1 else make_stage2_step
    step = make(cfg, **({} if mesh is None else dict(mesh=mesh, state_sharding=specs)))
    b = {k: v.to(dev) for k, v in shard_batch(batch, mesh).items()}
    out = {"terms": [], "launches": [], "gathers": [], "ms": []}
    for _ in range(steps):
        torch.cuda.synchronize()
        reset_counts()
        spatial.gather_rows.calls = 0
        t = time.perf_counter()
        state, terms = step(state, *args, b)
        out["terms"].append({k: float(v) for k, v in terms.items()})
        torch.cuda.synchronize()
        out["ms"].append(1e3 * (time.perf_counter() - t))
        out["launches"].append(read_counts())
        out["gathers"].append(spatial.gather_rows.calls)
    out["grads"] = grads
    return out


def p29_runs(cfg, weights, meshes):
    """Every run of (a) on ``meshes`` ({"tp": ..., "sp": ...}; None: the
    one-process references, one run for each distinct config), by
    (case, axis, precision): fp32 one step, bf16 two (the second
    timed)."""
    from gdn_tpu_torch.config import _with

    out, cache = {}, {}
    for tag, over, stage in P29_GRID:
        for axis, key in P29_AXES:
            m = None if meshes is None else meshes[axis]
            c = _with(cfg, **over, **({} if m is None else {key: 2}))
            for prec, rc, steps in (("fp32", _with(c, **F32), 1), ("bf16", c, 2)):
                k = (tag, rc.model, steps)
                if m is None and k in cache:
                    out[tag, axis, prec] = cache[k]
                    continue
                out[tag, axis, prec] = cache[k] = p29_step(rc, weights[tag], weights["batch"],
                                                           m, stage, steps)
    return out


def p29_rank(out_dir, weights_path):
    """The two ranks of phase 29 (a)-(c): every result into
    ``out_dir/rank<r>.pt``."""
    sys.path.insert(0, ROOT)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from gdn_tpu_torch import kernels as port_kernels
    from gdn_tpu_torch.config import _with, kitti_config, nyu_config
    from gdn_tpu_torch.parallel import multihost
    from gdn_tpu_torch.parallel.mesh import create_mesh

    port_kernels.load_all()  # built by the parent: loads
    r = multihost.rank()
    weights = torch.load(weights_path, weights_only=False)
    cfg = kitti_config(**{"model.use_pallas_gn": True})
    meshes = {"tp": create_mesh(0, model=2, device_type="cuda"),
              "sp": create_mesh(0, spatial=2, device_type="cuda"),
              "data": create_mesh(0, device_type="cuda")}
    res = {"rank": r, "grid": p29_runs(cfg, weights, meshes)}
    nyu = _with(nyu_config(**{"model.use_pallas_gn": True}), **{"mesh.spatial_devices": 2})
    nw = (weights["nyu"], weights["nyu_batch"])
    res["nyu"] = {"fp32": p29_step(_with(nyu, **F32), *nw, meshes["sp"], 2),
                  "bf16": p29_step(nyu, *nw, meshes["sp"], 2, steps=2)}
    fg = _with(cfg, **P29_GRID[3][1], **{"mesh.fsdp": True})
    res["fsdp_fg"] = {"fp32": p29_step(_with(fg, **F32), weights["fg"], weights["batch"],
                                       meshes["data"], 2),
                      "bf16": p29_step(fg, weights["fg"], weights["batch"], meshes["data"], 2,
                                       steps=2)}
    torch.save(res, os.path.join(out_dir, f"rank{r}.pt"))


def p29_rank4(out_dir, weights_path):
    """The four ranks of (c): FSDP on data 2 x spatial 2, stage 1 of the
    default net, fp32 and bf16 (without the gradient term)."""
    sys.path.insert(0, ROOT)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from gdn_tpu_torch import kernels as port_kernels
    from gdn_tpu_torch.config import _with, kitti_config
    from gdn_tpu_torch.parallel import multihost
    from gdn_tpu_torch.parallel.mesh import create_mesh

    port_kernels.load_all()
    weights = torch.load(weights_path, weights_only=False)
    cfg = kitti_config(**{"model.use_pallas_gn": True, "mesh.fsdp": True,
                          "mesh.spatial_devices": 2})
    mesh = create_mesh(0, spatial=2, device_type="cuda")
    w, b = weights["fg"], weights["batch"]
    res = {"rank": multihost.rank(),
           "fp32": p29_step(_with(cfg, **F32), w, b, mesh, 1),
           "bf16": p29_step(cfg, w, b, mesh, 1, steps=2)}
    torch.save(res, os.path.join(out_dir, f"fsdp_sp_rank{multihost.rank()}.pt"))


def p29_split_gn(cfg, nyu):
    """The split GN+ELU kernel against its plain version (``_rows_plain``,
    the same arguments) at the shapes this phase gives it: each rank's
    uneven shard of every site of the NYU net at 228x304 over two ranks
    (B=8, bf16; the count of the whole image's rows), and each site of the
    paired encoder ladder at KITTI's half rows (2C channels, 2G groups).
    On a spatial axis of extent 1: both launches, no collective."""
    from gdn_tpu_torch.kernels import groupnorm as gnk
    from gdn_tpu_torch.ops.groupnorm import pick_groups
    from gdn_tpu_torch.parallel.mesh import Axis
    from gdn_tpu_torch.parallel.spatial import row_sizes

    alone = Axis(None, 1, 0)
    gen = torch.Generator(device="cuda").manual_seed(29)
    m = cfg.model
    shapes = {(c, part, w, h, pick_groups(c, m.group_norm_groups))
              for c, h, w in gn_sites(nyu.model) for part in row_sizes(h, 2)}
    n_enc = 1 + 2 * len(m.enc_channels)
    shapes |= {(2 * c, h // 2, w, h, 2 * pick_groups(c, m.group_norm_groups))
               for c, h, w in gn_sites(m)[:n_enc]}
    worst = 0.0
    for c, part, w, h, g in sorted(shapes, reverse=True):
        x = _gn_input((P29_BATCH, c, part, w), torch.bfloat16, gen)
        scale = torch.rand(c, device="cuda", generator=gen) + 0.5
        bias = torch.randn(c, device="cuda", generator=gen)
        what = f"group_norm_elu_rows ({P29_BATCH}, {c}, {part} of {h}, {w}), {g} groups"
        out, stats = split_gn_twice(x, scale, bias, g, alone, h, what)
        want, want_stats = gnk._rows_plain(x, scale, bias, g, 1e-6, alone, h)
        torch.cuda.synchronize()
        worst = max(worst, check_close(out, want, x.dtype, what))
        check_tol(stats, want_stats, 1e-5, 1e-6, f"{what} statistics")
        ops = check_split_call(lambda: gnk._launch_rows(x, scale, bias, g, 1e-6, alone, h),
                               what)
    log(f"  the split GN+ELU kernel vs plain at {len(shapes)} shapes (NYU's uneven shards, "
        f"the paired ladder's 2G groups): max|k-p| {worst:.3g}; two calls bit for bit; "
        f"each call {' + '.join(SPLIT_KERNELS)} and {len(ops)} allocations, no other op")
    return {"shapes": len(shapes), "max_abs_err": worst, "ops_a_call": ops}


def p29_scripts(work):
    """(d): the P29_SCRIPTS commands at once (each spawns its ranks),
    stage 1 for P29_SCRIPT_STEPS steps at batch 8; each checkpoint
    restored in this process and run once."""
    from gdn_tpu_torch.checkpoint import latest_step, load_config, restore_checkpoint
    from gdn_tpu_torch.models import DtoDNet
    from gdn_tpu_torch.train.state import TrainState

    out, procs = {}, {}
    t0 = time.perf_counter()
    for tag, flags in P29_SCRIPTS:
        log_file = open(os.path.join(work, f"train_{tag}.log"), "w")
        procs[tag] = (subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "scripts", "train_torch.py"), "--mode",
             "DtoD", *flags, "--dataset", "synthetic", "--epochs", "1", "--steps_per_epoch",
             str(P29_SCRIPT_STEPS), "--batch_size", "8", "--log_every", "1", "--ckpt_dir",
             os.path.join(work, tag)], cwd=ROOT, stdout=log_file, stderr=subprocess.STDOUT),
            log_file)
    for tag, (proc, log_file) in procs.items():
        rc = proc.wait(timeout=400)
        log_file.close()
        if rc != 0:
            raise AssertionError(f"(d) train_torch.py {tag} failed: see {log_file.name}")
    dev = torch.device("cuda")
    for tag, _ in P29_SCRIPTS:
        d = os.path.join(work, tag, "stage1")
        cfg = load_config(d)
        net = DtoDNet(cfg.model).to(dev)
        state = restore_checkpoint(d, TrainState(net, cfg.train, 10))
        h, w = cfg.model.image_size
        with torch.no_grad():
            depth = net(torch.rand(2, h, w, 1, device=dev))["depth"]
        torch.cuda.synchronize()
        ok = bool(torch.isfinite(depth).all()) and tuple(depth.shape) == (2, h, w, 1)
        out[tag] = {"step": state.step, "latest": latest_step(d), "finite": ok,
                    "image_size": [h, w], "upsample": cfg.model.upsample,
                    "norm": cfg.model.norm,
                    "mesh": {"model": cfg.mesh.model_devices,
                             "spatial": cfg.mesh.spatial_devices}}
        if not ok or state.step != P29_SCRIPT_STEPS:
            raise AssertionError(f"(d) {tag} checkpoint: step {state.step}, forward finite "
                                 f"and shaped {ok}")
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_split_knobs(cfg):
    """Phase 29: the model variants, fused guidance and the paired
    encoders under TP and SP, NYU at 228 x 304 under SP, FSDP with fused
    guidance and on a spatial mesh, the script (see the module
    docstring)."""
    from gdn_tpu_torch.config import _with, nyu_config
    from gdn_tpu_torch.parallel.multihost import run_ranks

    t0 = time.perf_counter()
    out, launches, problems = {"device": smi_line()}, {}, []
    log(f"  {out['device']}")
    work = os.path.join(OUT, "p29")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    nyu = nyu_config(**{"model.use_pallas_gn": True})
    weights = {"batch": p29_batch(cfg), "nyu": p29_weights(nyu, 291),
               "nyu_batch": p29_batch(nyu, 292)}
    for i, (tag, over, _) in enumerate(P29_GRID):
        weights[tag] = p29_weights(_with(cfg, **over), 293 + 2 * i)
    path = os.path.join(work, "weights.pt")
    torch.save(weights, path)
    out["split_gn"] = p29_split_gn(cfg, nyu)  # its launches count on no path
    ts = time.perf_counter()
    single = p29_runs(cfg, weights, None)
    nw = (weights["nyu"], weights["nyu_batch"])

    def one_process(c, w, batch, stage):
        return {"fp32": p29_step(_with(c, **F32), w, batch, None, stage),
                "bf16": p29_step(c, w, batch, None, stage, steps=2)}

    single_nyu = one_process(nyu, *nw, 2)
    single_fsdp = {k: single["fg", "tp", k] for k in ("fp32", "bf16")}
    single_fsdp_sp = one_process(cfg, weights["fg"], weights["batch"], 1)
    out["single_seconds"] = time.perf_counter() - ts
    ts = time.perf_counter()
    run_ranks(p29_rank, P29_RANKS, (work, path), device_type="cuda", timeout=900)
    out["ranks_seconds"] = time.perf_counter() - ts
    ts = time.perf_counter()
    run_ranks(p29_rank4, P29_FSDP_RANKS, (work, path), device_type="cuda", timeout=600)
    out["ranks4_seconds"] = time.perf_counter() - ts
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(P29_RANKS)]
    ranks4 = [torch.load(os.path.join(work, f"fsdp_sp_rank{r}.pt"), weights_only=False)
              for r in range(P29_FSDP_RANKS)]

    def held(what, got, one):
        """A case's runs ``got`` against one process's ``one`` (each by
        precision): fp32 terms within 1e-4 and gradients within 1e-3 of
        each tensor's largest; bf16 terms within phase 28's 5%, gradients
        within its 5% or, where larger, one process's own bf16-to-fp32
        gap (see F32's note)."""
        row = {"bf16_own_gap": _grad_gap(one["bf16"]["grads"], one["fp32"]["grads"])}
        for prec, tt, gt in (("fp32", 1e-4, 1e-3),
                             ("bf16", BF16_TERMS_TOL, max(BF16_GRAD_TOL, row["bf16_own_gap"]))):
            g, w = got[prec], one[prec]
            gaps = {k: _grad_gap({k: g["grads"][k]}, {k: v}) for k, v in w["grads"].items()}
            worst = max(gaps, key=gaps.get)
            row[prec] = {"terms_rel_gap": _terms_gap(g["terms"][:1], w["terms"][:1])[0],
                         "grad_rel_gap": gaps[worst], "worst": worst, "grad_bound": gt}
            if row[prec]["terms_rel_gap"] > tt:
                problems.append(f"{what} {prec} terms {row[prec]['terms_rel_gap']:.3g} beyond "
                                f"{tt}")
            if gaps[worst] > gt:
                problems.append(f"{what} {prec} gradients {gaps[worst]:.3g} ({worst}) beyond "
                                f"{gt:.3g} of their largest")
        return row

    def launch_check(what, got, want, rows):
        """Each rank's launches by kernel: under TP the one process's;
        under SP the one process's GN+ELU launches as split ones, no
        one-launch GN+ELU and no fused loss (SP takes the plain terms)."""
        if rows:
            want = {k: 0 for k in COUNTERS} | {
                "group_norm_elu_rows": want["group_norm_elu"]}
        if got != want:
            problems.append(f"{what} launches {got} != {want}")

    # (a) the knob grid
    out["grid"] = {}
    for tag, over, stage in P29_GRID:
        for axis, _ in P29_AXES:
            name = f"(a) {tag} {axis}"
            row = held(name, {p: ranks[0]["grid"][tag, axis, p] for p in ("fp32", "bf16")},
                       {p: single[tag, axis, p] for p in ("fp32", "bf16")})
            for prec in ("fp32", "bf16"):
                one = single[tag, axis, prec]
                for rk in ranks:
                    rec = rk["grid"][tag, axis, prec]
                    key = f"split_{tag}_{axis}_{prec}_rank{rk['rank']}"
                    launches[key] = rec["launches"][0]
                    launch_check(f"{name} {prec} rank {rk['rank']}", rec["launches"][0],
                                 one["launches"][0], axis == "sp")
            one_gn = single[tag, axis, "bf16"]["launches"][0]["group_norm_elu"]
            if tag in ("deconv_add_ms_gelu", "none_relu") and one_gn:
                problems.append(f"{name}: {one_gn} GN+ELU launches in a net without ELU "
                                "GroupNorm")
            row["ms_per_step"] = {"single": single[tag, axis, "bf16"]["ms"][1],
                                  "ranks": [rk["grid"][tag, axis, "bf16"]["ms"][1]
                                            for rk in ranks]}
            row["launches"] = {k: v for k, v in
                               ranks[0]["grid"][tag, axis, "bf16"]["launches"][0].items() if v}
            row["gathers"] = ranks[0]["grid"][tag, axis, "bf16"]["gathers"][0]
            out["grid"][f"{tag}_{axis}"] = row
            log(f"  {name}: fp32 terms {row['fp32']['terms_rel_gap']:.3g} gradients "
                f"{row['fp32']['grad_rel_gap']:.3g}; bf16 terms "
                f"{row['bf16']['terms_rel_gap']:.3g} gradients "
                f"{row['bf16']['grad_rel_gap']:.3g} ({row['bf16']['worst']}; bound "
                f"{row['bf16']['grad_bound']:.3g}: one process's bf16 from its fp32 "
                f"{row['bf16_own_gap']:.3g})"
                + f"; ms/step one process {row['ms_per_step']['single']:.1f}, ranks "
                + ", ".join(f"{x:.1f}" for x in row["ms_per_step"]["ranks"])
                + f"; launches a rank {row['launches']}; row gathers {row['gathers']}")
    # (b) NYU at 228 x 304 under SP
    row = held("(b) nyu sp", ranks[0]["nyu"], single_nyu)
    for rk in ranks:
        for prec in ("fp32", "bf16"):
            rec = rk["nyu"][prec]
            launches[f"split_nyu_{prec}_rank{rk['rank']}"] = rec["launches"][0]
            launch_check(f"(b) nyu {prec} rank {rk['rank']}", rec["launches"][0],
                         single_nyu[prec]["launches"][0], True)
    row["gathers"] = ranks[0]["nyu"]["bf16"]["gathers"]
    row["rows_launches"] = ranks[0]["nyu"]["bf16"]["launches"][0]["group_norm_elu_rows"]
    row["ms_per_step"] = {"single": single_nyu["bf16"]["ms"][1],
                          "ranks": [rk["nyu"]["bf16"]["ms"][1] for rk in ranks]}
    if not row["rows_launches"] or not row["gathers"][0]:
        problems.append(f"(b) nyu: split GN+ELU launches {row['rows_launches']}, gathers "
                        f"{row['gathers']}")
    out["nyu"] = row
    log(f"  (b) NYU {P29_NYU[0]}x{P29_NYU[1]} SP=2 stage 2: fp32 terms "
        f"{row['fp32']['terms_rel_gap']:.3g} gradients {row['fp32']['grad_rel_gap']:.3g}; "
        f"bf16 terms {row['bf16']['terms_rel_gap']:.3g} gradients "
        f"{row['bf16']['grad_rel_gap']:.3g} ({row['bf16']['worst']}; bound "
        f"{row['bf16']['grad_bound']:.3g}: one process's bf16 from its fp32 "
        f"{row['bf16_own_gap']:.3g}); split GN+ELU launches a rank a step "
        f"{row['rows_launches']}, row gathers a step {row['gathers'][0]}; ms/step one "
        f"process {row['ms_per_step']['single']:.1f}, ranks "
        + ", ".join(f"{x:.1f}" for x in row["ms_per_step"]["ranks"]))
    # (c) FSDP
    out["fsdp"] = {}
    for tag, got_ranks, want in (("fg", [rk["fsdp_fg"] for rk in ranks], single_fsdp),
                                 ("data2_spatial2", ranks4, single_fsdp_sp)):
        row = held(f"(c) fsdp {tag}", got_ranks[0], want)
        for i, rk in enumerate(got_ranks):
            for prec in ("fp32", "bf16"):
                launches[f"split_fsdp_{tag}_{prec}_rank{i}"] = rk[prec]["launches"][0]
                launch_check(f"(c) fsdp {tag} {prec} rank {i}", rk[prec]["launches"][0],
                             want[prec]["launches"][0], tag != "fg")
        row["ms_per_step"] = {"single": want["bf16"]["ms"][1],
                              "ranks": [rk["bf16"]["ms"][1] for rk in got_ranks]}
        out["fsdp"][tag] = row
        log(f"  (c) FSDP {tag} ({len(got_ranks)} ranks): fp32 terms "
            f"{row['fp32']['terms_rel_gap']:.3g} gradients "
            f"{row['fp32']['grad_rel_gap']:.3g}; bf16 terms "
            f"{row['bf16']['terms_rel_gap']:.3g} gradients "
            f"{row['bf16']['grad_rel_gap']:.3g} ({row['bf16']['worst']}; bound "
            f"{row['bf16']['grad_bound']:.3g}: one process's bf16 from its fp32 "
            f"{row['bf16_own_gap']:.3g}); ms/step one process "
            f"{row['ms_per_step']['single']:.1f}, ranks "
            + ", ".join(f"{x:.1f}" for x in row["ms_per_step"]["ranks"]))
    # (d) the script
    reset_counts()
    out["scripts"] = p29_scripts(work)
    launches["split_scripts_parent"] = read_counts()
    sc = out["scripts"]
    log(f"  (d) train_torch.py " + ", ".join(f"{t} ({' '.join(f)})" for t, f in P29_SCRIPTS)
        + f", at once: {sc['seconds']:.1f} s; " + ", ".join(
            f"{t}: restored at step {r['step']} in one process, forward finite {r['finite']}"
            for t, r in sc.items() if t != "seconds"))
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 29 took {out['seconds']:.1f} s (one process {out['single_seconds']:.1f} s, "
        f"2 ranks {out['ranks_seconds']:.1f} s, 4 ranks {out['ranks4_seconds']:.1f} s)")
    if problems:
        raise AssertionError("phase 29: " + "; ".join(problems))
    return out, launches


P30_IMAGES = 16  # (b): two serving batches of BATCH
P30_STEPS = 2  # (c): stage-2 steps a run at TRAIN_BATCH


def reference_key_map(sd):
    """A key map (flax path -> torch key) that renames every leaf as the
    reference's modules might be named, ``encoder.down1.ConvBlock_0.
    Conv_0.kernel`` -> ``enc.layer3.kernel``."""
    from gdn_tpu_torch.checkpoint import flax_path

    km = {flax_path(k): f"{'enc' if k.startswith('encoder.') else 'dec'}.layer{i}."
          f"{k.rsplit('.', 1)[1]}" for i, k in enumerate(sd)}
    if len(set(km.values())) != len(km) or set(km.values()) & set(sd):
        raise AssertionError("the key map must rename every leaf to a key of its own")
    return km


def _records(jsonl):
    """The loss terms of each logged step (the host clock left out)."""
    return [{k: v for k, v in json.loads(line).items() if k not in ("t", "imgs_per_sec")}
            for line in open(jsonl)]


def phase_migration(cfg, g_src, n_gn):
    """Phase 30: reference-style .pth files of a D-net and a G-net, under
    a key map that renames every leaf, wrapped as {"state_dict": ...}
    with DataParallel's keys, imported by scripts/import_pth_torch.py on
    the card; the stage-2 import served and the stage-1 import trained
    from against the source weights in the same call, bit for bit (cuDNN
    deterministic); both exported by scripts/export_pth_torch.py under
    the same map and held to the files imported."""
    from gdn_tpu_torch.checkpoint import flax_path, init_params, load_params, save_pth
    from gdn_tpu_torch.serving import BatchedPredictor

    t0 = time.perf_counter()
    root = os.path.join(OUT, "migration")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    sources = {"1": init_params(cfg.model, torch.Generator().manual_seed(30), in_channels=1),
               "2": g_src}
    files = {}
    for stage, src in sources.items():
        km = reference_key_map(src)
        pth, kmp = os.path.join(root, f"ref{stage}.pth"), os.path.join(root, f"map{stage}.json")
        with open(kmp, "w") as f:
            json.dump(km, f)
        ref = {km[flax_path(k)]: v.clone() for k, v in src.items()}
        torch.save({"state_dict": {f"module.{k}": v for k, v in ref.items()}, "epoch": 30}, pth)
        files[stage] = (ref, kmp)
        load_script("import_pth_torch").main(
            ["--pth", pth, "--stage", stage, "--key_map", kmp, "--model_dir", root])
        got = load_params(os.path.join(root, f"stage{stage}"), step=0)
        if got.keys() != src.keys() or not all(torch.equal(got[k], src[k]) for k in src):
            raise AssertionError(f"(a) the stage-{stage} import differs from its source")
    log(f"  (a) imported a D-net ({len(sources['1'])} tensors) and a G-net "
        f"({len(sources['2'])}) from reference-style .pth files, every key renamed, "
        f"'module.' keys inside {{'state_dict': ...}}: bit for bit")

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    h, w = cfg.model.image_size
    images = np.random.default_rng(30).integers(0, 256, (P30_IMAGES, h, w, 3), np.uint8)
    depths, counts = {}, {}
    for tag, sd in (("import", load_params(os.path.join(root, "stage2"))), ("source", g_src)):
        pred = BatchedPredictor(cfg, sd, batch_size=BATCH)
        pred.predict(images[:BATCH])
        torch.cuda.synchronize()
        reset_counts()
        depths[tag] = pred.predict(images)
        counts[f"serve_{tag}"] = read_counts()
        del pred
    batches = P30_IMAGES // BATCH
    expect_counts("migration serving", counts["serve_import"], group_norm_elu=n_gn * batches)
    if not np.array_equal(depths["import"], depths["source"]):
        raise AssertionError("(b) the imported G-net's depth differs from its source's: max "
                             f"|d| {np.abs(depths['import'] - depths['source']).max()}")
    log(f"  (b) BatchedPredictor, batch {BATCH}, {h}x{w}, bf16: {P30_IMAGES} images from the "
        f"stage-2 import bit-identical to the source weights; launches "
        f"{counts_text(counts['serve_import'])}")

    save_pth(sources["1"], os.path.join(root, "d_source.pth"))
    train = ["--mode", "RtoD", "--dataset", "synthetic", "--batch_size", str(TRAIN_BATCH),
             "--epochs", "1", "--steps_per_epoch", str(P30_STEPS), "--log_every", "1"]
    records = {}
    for tag, src in (("import", ["--stage1_ckpt", os.path.join(root, "stage1")]),
                     ("source", ["--stage1_pth", os.path.join(root, "d_source.pth")])):
        out = os.path.join(root, f"from_{tag}")
        torch.cuda.synchronize()
        reset_counts()
        state = load_script("train_torch").main([*train, *src, "--model_dir", out])
        torch.cuda.synchronize()
        counts[f"train_{tag}"] = read_counts()
        records[tag] = _records(os.path.join(out, "train_log.jsonl"))
        if state.step != P30_STEPS:
            raise AssertionError(f"(c) {tag}: stopped at step {state.step}")
        del state
    torch.backends.cudnn.deterministic = False
    expect_counts("migration stage 2", counts["train_import"],
                  group_norm_elu=2 * n_gn * P30_STEPS, fused_loss_fwd=P30_STEPS,
                  fused_loss_bwd=P30_STEPS)
    if records["import"] != records["source"] or len(records["import"]) != P30_STEPS:
        raise AssertionError(f"(c) stage 2 from the import {records['import']} against the "
                             f"source {records['source']}")
    log(f"  (c) train_torch.py --mode RtoD --stage1_ckpt on the stage-1 import, B={TRAIN_BATCH}, "
        f"{P30_STEPS} steps: terms equal to --stage1_pth of the source bit for bit ("
        + ", ".join(f"total={r['total']:.6f}" for r in records["import"])
        + f"); launches {counts_text(counts['train_import'])}")

    for stage, (ref, kmp) in files.items():
        pth = os.path.join(root, f"out{stage}.pth")
        load_script("export_pth_torch").main(
            ["--stage", stage, "--model_dir", root, "--pth", pth, "--key_map", kmp])
        back = torch.load(pth, weights_only=True)
        if back.keys() != ref.keys() or not all(torch.equal(back[k], ref[k]) for k in ref):
            raise AssertionError(f"(d) the stage-{stage} export differs from the file imported")
    seconds = time.perf_counter() - t0
    log(f"  (d) export_pth_torch.py under the same key maps: both files equal the ones "
        f"imported, key for key, bit for bit")
    log(f"  (e) phase 30: {seconds:.1f} s; launches {counts_text(counts['serve_import'])} "
        f"serving {P30_IMAGES} images, {counts_text(counts['train_import'])} in "
        f"{P30_STEPS} stage-2 steps")
    launches = {"migration_serving": counts["serve_import"],
                "migration_stage2": counts["train_import"]}
    return {"seconds": seconds, "launches": counts,
            "terms": records["import"]}, launches


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
    del s2, d_net

    log(f"== 20. eval: {EVAL_IMAGES} images, GT {EVAL_GT[0]}x{EVAL_GT[1]}, batch "
        f"{EVAL_BATCH}, garg crop, cap 80, bf16, full width")
    evaluation, eval_launches = phase_eval(cfg, cfg_all, sd)

    log("== 21. lifecycle: resume, preemption, grad_accum, remat, the command line")
    lifecycle, life_launches = phase_lifecycle(cfg, cfg_fused, cfg_fusion)

    log("== 22. data from disk: KITTI and NYU loaders, decode and device caches, "
        "the on-card wire decode and augmentation")
    disk, disk_launches = phase_disk(cfg, cfg_fused, training)

    log("== 23. tools: the grain loader's counterpart, the command line, the numerics "
        "guard, the convergence protocol, profile_step, the benches and the demo")
    tools, tools_launches = phase_tools(cfg, disk, training)

    log("== 24. artifacts: torch.export of the serving forward with the kernels as "
        "registered ops, and int8 post-training quantization")
    artifacts, art_launches = phase_artifacts(
        {"unfused": cfg, "all": cfg_all, "fusion": cfg_fusion, "v1": cfg_v1},
        {"unfused": {"group_norm_elu": n_gn},
         "all": {"group_norm_elu": 1, "conv_gn_elu_s2": 5, "conv_gn_elu_bt": 5,
                 "fusion_bt": 5, "upsample": 5},
         "fusion": fusion_per_net,
         "v1": {"group_norm_elu": 16, "conv_gn_elu": 5}}, sd, disk)

    log("== 25. model variants: the deconv decoder with multi-scale heads served and "
        "trained at full width, the variant grid against the CPU, the entry points")
    variants, variant_launches = phase_variants(cfg, sd)

    log("== 26. knobs: fused guidance, its hand-written backward, paired encoders, "
        "multistep and the remat policies, trained at full width")
    knobs, knob_launches = phase_knobs(cfg)

    log(f"== 27. parallel: data parallel and FSDP over {P27_RANKS} ranks sharing the card "
        "(gloo), DP at world size 1 over NCCL, DP eval, the sharded device cache")
    parallel, parallel_launches, refs = phase_parallel(cfg)

    log(f"== 28. tp_sp: tensor and spatial parallelism over {P28_RANKS} ranks sharing the "
        "card (gloo): the split GN+ELU kernel, TP and SP training against one process, "
        "kernels 4-9 under TP, a tall image's memory, the script")
    tp_sp, tp_sp_launches = phase_tp_sp(cfg, refs)
    del refs

    log(f"== 29. split knobs: the model variants, fused guidance and the paired encoders "
        f"under TP and SP over {P29_RANKS} ranks sharing the card (gloo), NYU at "
        f"{P29_NYU[0]}x{P29_NYU[1]} under SP, FSDP with fused guidance and on data 2 x "
        "spatial 2, the script")
    split_knobs, split_launches = phase_split_knobs(cfg)

    log("== 30. migration: reference-style .pth files under a key map imported, served and "
        "trained from bit-identically to their source, exported back")
    migration, migration_launches = phase_migration(cfg, sd, n_gn)

    main_rows = [r for r in rows if r["dtype"] == str(torch.bfloat16)]
    per_fwd = {k: sum(r[k] * r["sites"] for r in main_rows)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    main_loss = loss_rows[0]
    path_launches = {"serving": serving_counts, **train_launches,
                     "serving_fused": fused_counts, "serving_v1": v1_counts,
                     **{f"{k}_fused": v for k, v in fused_train_launches.items()},
                     "serving_fusion": fusion_counts, "serving_all": all_counts,
                     **{f"{k}_fusion": v for k, v in fusion_train_launches.items()},
                     **eval_launches, **life_launches, **disk_launches,
                     **tools_launches, **art_launches, **variant_launches,
                     **knob_launches, **parallel_launches, **tp_sp_launches,
                     **split_launches, **migration_launches}

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
    split_rows = tp_sp["split_gn"]
    kernels.append({
        "name": "group_norm_elu_rows",
        "route": "cuda",
        "source": "gdn_tpu_torch/csrc/group_norm_elu.cu",
        "replaces": "gdn_tpu/kernels/groupnorm.py:133",
        "launches": total("group_norm_elu_rows"),
        "max_abs_err": max([r["max_abs_err"] for r in split_rows]
                           + [split_knobs["split_gn"]["max_abs_err"]]),
        **{k: sum(r[k] * r["sites"] for r in split_rows)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
        "bound_by": "bytes",
    })
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
                   "eval": evaluation, "lifecycle": lifecycle, "disk": disk,
                   "tools": tools, "artifacts": artifacts, "variants": variants,
                   "knobs": knobs, "parallel": parallel, "tp_sp": tp_sp,
                   "split_knobs": split_knobs, "migration": migration,
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
