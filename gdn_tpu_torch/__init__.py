"""gdn_tpu_torch: the PyTorch/CUDA port of gdn-tpu for NVIDIA Hopper.

The JAX package ``gdn_tpu`` is the reference; this package mirrors its
module layout and names and imports nothing from it (nor JAX).  Every
TPU kernel on a ported path has a hand-written CUDA counterpart under
``csrc/`` with a plain PyTorch version beside its wrapper; entry points
run on CUDA unless the caller passes ``device="cpu"``.

Ported so far: the stage-2 G-net serving path (config, ops, models,
checkpoint import, BatchedPredictor, the HTTP server) with the
GroupNorm+ELU kernel; the training of both stages (losses with the
fused loss kernels, train state/steps/loops, synthetic data) with
checkpoints, resume, preemption, gradient accumulation and remat; and
the eval protocol.  See ROADMAP.md for what comes next.
"""

__version__ = "0.1.0"
