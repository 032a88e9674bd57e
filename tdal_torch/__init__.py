"""tdal_torch — the PyTorch / NVIDIA H100 port of tdal.

Same module layout and names as ``tdal`` (the JAX package, which stays the
reference). Plain tensor code is PyTorch; every Pallas TPU kernel on a ported path
becomes a hand-written CUDA kernel for ``sm_90a`` under ``tdal_torch/ops``, with a
plain-PyTorch twin beside it that defines what it computes.

- core/      codecs, geometry, rotated IoU (plain torch)
- ops/       the CUDA kernels, their twins, and the build that compiles them at first use
- models/    the PointPillars detector and the Frustum-PointNet static & dynamic
             labelers (train and eval forwards, the frustum losses)
- data/      on-disk schema, synthetic segments, detection and track datasets, the
             ``.tdc`` frame cache
- pipeline/  detector and labeler training and inference, stages 2-6, and the chained
             offboard pipeline (``offboard``: detect -> track -> extract -> motion
             split -> label)
- runtime/   config, schedules, AdamW, train state, checkpoints, logging
- tools/     the command-line entry points (``python -m tdal_torch.tools.<stage>``)
- convert    flax parameter trees (as numpy) -> the port's ``state_dict``s

Entry points take ``device=None``, which means ``cuda`` and raises without a card;
only an explicit ``device="cpu"`` runs on the CPU. Importing the package builds
nothing.
"""

__version__ = "0.1.0"
