"""gdn_tpu_torch: the PyTorch/CUDA port of gdn-tpu for NVIDIA Hopper.

The JAX package ``gdn_tpu`` is the reference; this package mirrors its
module layout and names and imports nothing from it (nor JAX).  Every
TPU kernel on a ported path has a hand-written CUDA counterpart under
``csrc/`` with a plain PyTorch version beside its wrapper; entry points
run on CUDA unless the caller passes ``device="cpu"``.

Every module of the JAX package has its counterpart: the stage-2 G-net
serving path (config, ops, models, BatchedPredictor, the HTTP server);
the training of both stages with checkpoints, resume, preemption,
gradient accumulation, remat and the training knobs; the model variants;
the eval protocol; data from disk; the command line and tools;
deployment (``torch.export`` artifacts whose graphs call the kernels as
registered ops, int8 post-training quantization); data, FSDP, tensor and
spatial parallelism over ``torch.distributed`` (``parallel/``); and the
``.pth`` migration path.  See ROADMAP.md for what the kernels and paths
still owe.
"""

__version__ = "0.1.0"
