"""Smoke run of the PyTorch/H100 port (``tdal_torch``) on one CUDA card.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA card and
the CUDA toolkit (it builds the kernels from ``tdal_torch/ops/csrc``), imports
nothing of JAX or of ``tdal``, and exits non-zero on any failure. Phases:

1. the device: torch's name for it and nvidia-smi's name and power limit;
   TF32 off for every reference product;
2. the kernels' build, timed, and each kernel instantiation's registers, shared memory
   and spills (``-Xptxas -v``); for the K1/K2 kernels also the HGMMA (wgmma) and HMMA
   (mma.sync) instructions in their SASS (``cuobjdump -sass -fun`` on those kernels of
   the built library): K1's and K2's main kernels and K2's gproj must hold HGMMA;
3. K1 (``fused_seg_encoder``) and K2 (``fused_seg_decoder``) against their plain
   twins at the labelers' production shapes (static B=64 N=4096 Cin=3, dynamic
   B=64 N=5120 Cin=4), in both operand modes, with kernel and twin times (CUDA
   events, warm, median of 20 calls of the wrapper on weights packed once, as
   ``PointNetSeg`` calls it), the packing's time, each kernel's bound and its share of
   it, the hand-written kernels alone (their launchers, 20 back to back) and, for K2,
   its per-set gproj kernel alone; beside them, as text, the recorded times of the
   f32-FMA CUDA-core kernels that came before (``FMA_KERNEL_MS``, not measured here).
   Each mode's error is also held against the mode gap (the other mode's kernel
   against this mode's twin), so a kernel that ignored the operand mode fails;
4. stages 2-6 end to end through ``tdal_torch.pipeline.offboard.label_chain`` on a
   synthetic segment (20 frames, 10 static + 10 dynamic objects, 30000 background
   points, 256 points per object) with
   detections fabricated from its GT and fresh-init labelers from a seeded
   ``torch.Generator``: one warm pass, then a timed pass with the launch counters
   set to 0 just before it and read just after. Both labelers must label boxes and
   each kernel must run once per predict batch. One batch of each labeler is then
   held against the same model on the CPU (plain layers, no kernel);
5. K3 (``conv3x3_fwd_stats``), K4 (``conv3x3_fwd``, as the dgrad with flipped,
   swapped weights), K5/K6 (``conv3x3_wgrad``) and K7 (``conv3x3_dgrad_act``, the
   dgrad of the chained sites) against their plain twins at the five stride-1 3x3 conv
   shapes of PointPillars training on the Waymo config (B=4: the RPN stages
   468^2x64, 234^2x128, 117^2x256, the head's shared conv 468^2x384->64 and its branch
   conv 468^2x64->320; K7 at the four with an input affine), three of VoxelNet's (B=4:
   the RPN stages 188^2x128 and 94^2x256, the head's shared conv 188^2x512->64; K7 at
   the two RPN stages) and a ragged 37x41 image
   with positive shifts (a halo leak shows there), in f32 and bf16 and with the input
   affine on and off; kernel, twin and cuDNN times (CUDA events, warm, median of 10;
   cuDNN with ``torch.backends.cudnn.benchmark`` on, so its own fastest algorithm, in
   a child process, so that the plans it finds stay out of phases 6-7; it runs while
   the script waits for the CPU lane at its end, which leaves the card idle, and phase
   5's cuDNN times are printed then) and the bound;
   for K7 also the unfused route (K4, then the mask and sums in torch) and cuDNN's
   ``conv2d_input`` with the same epilogue. Then K4 as ``conv3x3`` (the function of
   tdal's benchmark prototype, ``benchmarks/proto_pallas_conv.py``) in bf16 at the
   stage-1 shape; and the row halo forms of K3, K4, K5 and K7 (halo (1, 1), the BEV
   spatial partitioning's) at the kernels line's case, each timed beside its
   whole-image call on the same rows and held against the whole-image kernel on the
   map whose inner rows it computes;
6. PointPillars training end to end: ``configs/waymo/pp/waymo_centerpoint_pp_two_
   pfn_stride1_3x.py`` through the port's ``Config.fromfile``, ``build_detector``
   (fresh init from seed 0) and ``train_detector`` at batch 4 on a synthetic dataset
   (8 frames, 150000 background points each, ``max_points`` 200000): a snapshot epoch
   (2 steps) under ``deterministic`` (cuDNN's deterministic algorithms, torch's
   deterministic mode; the ops without a deterministic version are printed), whose end
   is the weights and batch of the card-vs-CPU check below and of phase 10 (a), then
   with the settings restored a warm epoch (2 steps) and 2 epochs (4 steps) with the
   launch counters set to 0 just before and read just after. Every loss must be finite and every step must launch K3 and
   K5/K6 16 times (16 stride-1 3x3 convs), K7 12 times (the 12 that take their
   producer's BN + ReLU) and K4 4 times (the other 4). The step alone is timed, and
   one more step runs under ``torch.profiler``: device time by kernel name (top 10),
   the conv kernels' share of the step and the device's idle share.
   Then one train step on the card from the snapshot (on its batch's first 2 frames: the
   CPU copy's six steps at batch 4 took 406-527 s), under ``deterministic``, so that
   the verdict is a function of the code and not of the run, is held against the same
   step on a CPU copy
   (plain versions, no kernel): the loss, the BN running statistics, the gradients
   within 8x a noise floor measured on the CPU copy (the change under a permutation
   of the batch or under two rounding-level changes of the weights, each taken both
   ways; for the SepHead's final cuDNN conv plus both libraries' f32 error against
   float64), and the parameters after the AdamW update. Two controls must fail that
   comparison: the card's step without the 2*y*gss term of the statistics' backward,
   and the step of the same weights with bf16 activations. The CPU copy's steps (the
   step and its noise-floor steps) run in the CPU lane: one child process (a
   ``ProcessPoolExecutor`` worker) that computes the CPU references of phases 6, 9 (a) and 12 (b) one after
   another while this process goes on with the card's phases; the card's
   steps and controls run in the phase, and each check is judged, its readings printed,
   after phase 14 (a failing check exits non-zero there);
7. PointPillars inference on the Waymo config's test settings (468^2 BEV, 60000
   pillars, NMS pre 4096 / post 500 at IoU 0.7, score 0.1) with the weights phase 6
   trained: ``run_inference`` over a synthetic test split (24 frames of 150000
   background points) at batch 4, plain and double-flip, with the middle third's
   synchronised seconds per frame, kept boxes per frame and peak memory; the forward
   and the decode + NMS of one batch timed apart; one batch held against a CPU copy
   (decoded maps within ``MAP_TOL``; kept sets equal except candidates on a knife
   edge, counted and printed); ``evaluate_detector``'s AP/APH on the split;
8. the offboard chain, in two parts. (a) Both labelers trained at their production
   widths (static one-box 4096 points, 512 object points; dynamic 5 x 1024 points) on a
   GT-fed segment of 8 scenes (160 static and 16 dynamic tracks through stages 2-4 on
   the card) by ``train_labeler`` at batch 64 for 3 epochs (drop_last: 2 steps an
   epoch), with the per-epoch eval through K1/K2 (its launches must equal the eval
   batches) and the best checkpoint, then ``restore_labeler_state``,
   ``predict_final_boxes`` and the postprocess metrics; the step alone is timed, and
   one train step of 8 sets on the card is held against the same step on a CPU copy
   (same weights, batch, gather noise and dropout mask; sets whose seg mask differs
   only at knife-edge points counted and taken out; loss, BN running statistics,
   gradients within 8x a noise floor measured on the CPU copy as phase 6 measures its
   own, parameters after the update), and the same step with torch's unbiased running
   variance must fail it. (b) The Waymo PP detector, from phase 6's snapshot, trained
   under ``deterministic`` (so the rounds it needs are the same in every run) in
   rounds of 45 steps (batch 4, Adam 3e-3 clipped at 35, at most 180 steps, each step
   K3 16, K4 4, K7 12, K5/K6 16 launches) on a bus-sized segment (10 frames, 6 static
   and 2 dynamic objects, no global augmentation noise) until the chain it feeds labels
   a static box; then ``tdal_torch.pipeline.offboard.measure`` (a warm pass on an
   8-frame segment, then the timed pass with the K1/K2 counters from 0): detect, track
   (the 90th-percentile score threshold), extract (GT match at IoU 0.25), the motion
   split and both trained labelers, with frames/s, each stage's seconds and the counts;
   K1/K2 must launch once per predict batch;
9. sparse VoxelNet and the two-stage detector on the Waymo configs. (a) Training of
   ``configs/waymo/voxelnet/waymo_centerpoint_voxelnet_3x.py`` at full width (the
   40 x 1504 x 1504 grid, the sparse backbone, 384 BEV channels into the RPN, 512 out),
   f32, batch 4, through ``train_detector`` on 8 synthetic frames of 160000 background
   points (each must hold 150000 points and fill 100000 of the 180000 voxels; the
   occupied voxels at each backbone level are printed against their caps): a warm
   epoch under ``deterministic`` (its end is (c)'s first stage), then 2 epochs with
   the conv launch counters from 0 (per step K3 and K5/K6
   13, K7 10, K4 3), the step alone, the sparse backbone alone, one profiled step
   (device time by category and the idle share), and one step at batch 2 held against
   a CPU copy as phase 6 holds its own (plus the running statistics against their own
   noise floor), with a control whose subm backward drops a tap (must fail) and one
   with the unbiased running variance (printed). (b) ``run_inference`` at the test
   settings (400000 voxels, NMS pre 4096 / post 500 at IoU 0.7, score 0.1) with (a)'s
   weights over 12 synthetic frames: frames/s, forward and decode + NMS times, peak
   memory, and two frames held against a CPU copy as phase 7 holds its batch; then the
   sparse gather-GEMM kernel at the backbone's shapes (``sparse_kernel_check``: the 21
   contractions of one batch's forward, each timed beside its least time and its twin
   and held against the twin within 1e-5). (c) The
   frozen-first-stage two-stage config (first stage bf16 from (a)'s snapshot, RoIHead
   512 x 5 inputs, 128 RoIs an image), all under ``deterministic``, so that its check
   repeats: ``train_two_stage`` for an epoch, the step
   alone, the first stage unchanged, predict's frames/s, and one RoI head step against
   a CPU copy on the same RoIs, features, draws and dropout masks, with the unbiased
   running variance as a control that must fail;
10. data parallelism (``tdal_torch.parallel.mesh``) with phase 6's snapshot. (a) One
   PointPillars train step of the Waymo PP config at a global batch of 4 on two gloo
   ranks sharing the card (NCCL refuses two ranks on one device), against the
   single-process step on the card, both under ``deterministic``: the loss, every
   gradient, the parameters after the update and the running statistics, held by phase 6's comparison with its noise floor
   measured on the card (8x the change under a permutation of the batch and two
   mirrored pairs of rounding-level weight changes); each reading is printed as a share
   of its tolerance, both ranks must end with the same state, and two controls (per-rank
   BN statistics, per-rank loss normalizers) must fail it. (b) ``train_detector`` as one
   rank of an NCCL group (a warm epoch, then 2 timed epochs of 2 steps at batch 4, the
   conv launch counters from 0), its training frames/s beside phase 6's, the host
   seconds that building the whole global batch on every rank adds to a step, and the
   scaling reading: 12 train steps at 4 frames a card, no checkpoint writes. (c) The
   static labeler's step (production widths, 8 sets, fresh from seed 0) in (a)'s ranks
   against its single-process step, with phase 8's floor measured on the card, its
   knife-edge sets taken out, and the same two controls. (d) Where the machine has two
   cards, (a)'s step over NCCL across them, its ``train_detector`` frames/s (a smoke
   figure: 2 frames a card, checkpoint writes included) and the scaling reading at a
   global batch of 8 against (b)'s; otherwise the line ``one card: (d) not run``;
11. the port's data preparation and GT-aug training on the Waymo PP config: a training
   segment in the decoded per-frame layout (2 scenes of 8 frames, 150000 background
   points, 6 static and 2 dynamic vehicles a scene, 256 points each) through
   ``python -m tdal_torch.tools.create_data waymo_data_prep`` in a subprocess (its
   infos, dbinfos and ``.bin`` crops checked), then ``train_detector`` at batch 4 from
   phase 6's snapshot with the config's ``db_sampler`` enabled on that database (the
   training set from ``tdal_torch.tools.train.build_train_dataset``, the CLI's own): a
   warm epoch, then a timed epoch of 4 steps with the conv launch counters from 0. It
   prints the pasted boxes and points a frame, the host seconds of a batch of 4 with the
   sampler and without, training frames/s, peak memory, the losses and the launches a
   step, and fails on fewer than 1 pasted box a frame on average, a pasted box that
   collides with another box of its frame, a non-finite loss, or launches other than
   K3 16, K4 4, K7 12 and K5/K6 16 a step;
12. the deformable head on ``configs/waymo/voxelnet/waymo_centerpoint_voxelnet_two_
   sweeps_3x_with_velo.py`` with ``bbox_head.dcn_head`` set and nothing else changed
   (the 40 x 1504 x 1504 grid, the sparse backbone, two sweeps of six point features,
   the velocity head, the 10 code weights), bf16 as the config declares, batch 4, on 8
   synthetic frames of phase 9's slab, each with the frame 0.1 s before it as its
   previous sweep. (a) ``train_detector``: a warm epoch under ``deterministic`` (its end
   is (b)'s snapshot), then 2 steps with the conv launch counters from 0 (per step K3
   and K5/K6 13, K7 9, K4 4); the step alone, the head's forward + backward alone and
   its peak memory, peak memory, training frames/s. (b) One step of the snapshot in f32
   at batch 2 on the card against a CPU copy under ``deterministic``, held as phase 9
   (a) holds its own (the library error of the head's cuDNN convs included), with a
   sampler that splits coordinates by ``trunc`` in place of ``floor`` as a control that
   must fail; the sampling coordinates within 1e-6 of an integer and those whose floor
   differs between the card and the CPU are counted. (c) ``run_inference`` at the
   config's test settings over 8 frames after a warm pass (frames/s with the host data,
   forward and decode + NMS apart, peak memory) and one frame in f32 against a CPU copy
   as phase 7 holds its batch;
13. a checkpoint that ``tdal``'s ``CheckpointManager`` wrote (the committed fixture
   ``tests/data/tdal_ckpt``: a narrow PointPillars, two steps, its legacy layout and a
   flat ``.npz``; ``make_fixture.py`` there says how it was made), launching no hand
   kernel (a detector's eval forward is cuDNN): (a) in a fresh process in which jax,
   orbax, tensorstore, zstandard, zarr and numcodecs cannot be imported, every variant
   through ``load_checkpoint_uri`` (the directory's latest and best steps, a
   ``file://`` tarball made here, the ``.npz``, the legacy layout through
   ``migrate_legacy_conv_params``), every leaf bit-equal to tdal's, with the bytes,
   seconds and MB/s; (b) ``python -m tdal_torch.tools.dist_test --checkpoint`` on the
   directory over the fixture config's two synthetic frames on the card (TF32 off), the
   same weights' head maps within ``MAP_TOL`` of tdal's recorded maps, the kept
   candidates equal to those of tdal's maps but for knife edges (counted, as phase 7
   holds its batch), and the CLI's detections within ``MAP_TOL`` of tdal's
   ``run_inference`` output in every frame without a knife edge;
14. BEV spatial partitioning (``tdal_torch.parallel.mesh``; the detector's
   ``bev_sharding``) of the Waymo PP config at full width with phase 6's snapshot, f32,
   on two gloo ranks sharing the card (NCCL refuses two ranks on one device). First the
   conv kernels' halo forms against their twins with the same halo at the phase's conv
   sites on each rank's row slab (``conv_halo_twin_checks``: phase 5's PP shapes, H
   split as the phase splits it, halo (0, 1) and (1, 0), input affine on and off,
   phase 5's tolerances). (a) A batch
   of 4 of phase 7's test frames through the partitioned eval forward: each rank's rows
   at every RPN level, the gathered head maps against the one-process forward on the
   card within ``MAP_TOL`` and the kept sets equal but for knife edges (counted, as
   phase 7 counts them). (b) One train step at a global batch of 4, both ranks holding
   it whole, under ``deterministic``, against phase 10 (a)'s single-process step on
   the card with its noise floor (phase 6's comparison), every reading printed as a
   share of its tolerance; both ranks must end with the same state; the halo rows
   replaced by zeros, and BN moments per slab, must fail it; each rank must launch
   phase 6's counts a step (K3 16, K4 4, K7 12, K5/K6 16), every one in the halo form.
   (c) Where the machine has two cards, (a) over NCCL across two, with the forward's
   ms a batch and frames/s beside one card's; otherwise the line ``one card: (c) not
   run``. Then the checks of phases 6, 9 and 12 are judged on the CPU lane's
   references;
15. one line ``{"kernels": [...]}`` (K1, K2, K3, K4, K5/K6, K7, K4 again as the
   benchmark prototype's function, and the sparse gather-GEMM kernel), each kernel's
   ``launches`` from phases 8, 9, 10(b), 11, 12 and 14 (b) (the sparse kernel's from 9
   (a), (b), (c) and 12, each path's counted across it), the conv kernels' halo forms'
   times from phase 5, the sparse kernel's times from phase 9 (b)'s section;
16. the last line ``{"ok": true, "device": {...}}``. The seconds each phase took, and
   the whole script's, are printed before the ``kernels`` line, beside those recorded
   from a run without the CPU lane.

``--noise-probe STATES`` builds and then runs only ``noise_probe``: on the card, how
often phase 6's comparison would fail a step that differs by rounding alone.
``--offboard-only`` builds and then runs only phase 8, from phase 6's snapshot (its
first epoch alone), and prints no ``kernels`` line; ``--voxelnet-only``
builds and then runs only phase 9; ``--dp-only`` builds and then runs only phase 10,
from phase 6's snapshot (its first epoch alone); ``--pp-only`` builds and then runs
only phase 6;
``--data-prep-only`` builds and then runs only phase 11, from a fresh detector;
``--dcn-only`` builds and then runs only phase 12, and prints its seconds and peak
memory; ``--import-only`` runs only phase 13 (without the build, since it launches no
hand kernel) and prints its seconds; ``--sp-only`` builds and then runs only phase 14,
from phase 6's snapshot (its first epoch alone), measuring its own single-process
reference, and prints its seconds. Alone, a phase computes its checks' CPU references
in this process.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import copy
import io
import itertools
import json
import logging
import math
import multiprocessing
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit). f32 operands:
# what the card can do with products as accurate as f32 on its tensor cores, split TF32
# ("3xTF32": three TF32 products for each f32 product) at the 495 TFLOP/s TF32 peak,
# so 3 x FLOP / 495 TFLOP/s (the 67 TFLOP/s of the CUDA cores, the bound of f32 kernels
# without tensor cores, a 3xTF32 kernel beats). bf16 operands: the bf16 tensor cores.
PEAK_FLOPS = {False: 495e12 / 3, True: 989e12}
HBM_BYTES_PER_S = 3.35e12

# max |kernel - twin| / max(1, max |twin|), by operand mode (bf16_operands). f32: the
# same products summed in another order. bf16: a summation-order difference can move
# an activation across a bf16 rounding step before the next layer, which K2's logits
# (|logit| < 0.1 at random weights) show as up to 6.1e-4. A K2 run in the other mode
# differs by no more than 9.2e-4 at most, so the largest error cannot tell the modes
# apart: the RMS check below does, as the mode changes every value and a rounding
# step only a few (PERF.md has the card's readings).
TOL = {False: 1e-5, True: 2e-3}
MODE_MARGIN = 10  # the own-mode RMS error must be at most 1/10 of the mode gap's
SHAPES = {"static": (64, 4096, 3), "dynamic": (64, 5120, 4)}
SEGMENT = dict(n_scenes=1, n_frames=20, seed=0, n_static=10, n_dynamic=10,
               points_per_object=256, n_background=30000)
NPOINTS_STATIC, NPOINTS_DYNAMIC, PREDICT_BATCH = 4096, 1024, 64
REPLACES = {
    "fused_seg_encoder": "tdal/ops/pallas_pointnet.py:69",
    "fused_seg_decoder": "tdal/ops/pallas_pointnet.py:137",
}
SOURCE = "tdal_torch/ops/csrc/fused_pointnet.cu"

# The recorded times (ms) of the f32-FMA CUDA-core kernels that K1 and K2 were before
# they moved to the tensor cores, by case, on an NVIDIA H100 80GB HBM3 at 700.00 W
# (PERF.md section 6); printed beside phase 3's times as text, never as this run's
# numbers
FMA_KERNEL_MS = {
    "fused_seg_encoder": {"static f32": 2.843, "static bf16": 2.821,
                          "dynamic f32": 3.401, "dynamic bf16": 3.483},
    "fused_seg_decoder": {"static f32": 6.307, "static bf16": 6.583,
                          "dynamic f32": 7.825, "dynamic bf16": 8.142},
}

ENC_WIDTHS = (64, 64, 64, 128, 1024)
DEC_WIDTHS = (512, 256, 128, 128, 2)


def log(msg: str):
    print(msg, flush=True)


_CONV_ENTRY = re.compile(
    r"(conv3x3_kernel|wgrad_kernel)I(f|13__nv_bfloat16)Lb([01])E"
    r"(?:LNS_8EpilogueE([012])E)?Lb([01])E(?:Lb([01])E)?")
_EPILOGUES = ("affine", "stats", "dgrad_act")


def conv_build_report(build_log: str, lib) -> list:
    """Registers, shared memory (dynamic from the launcher, static from ptxas) and spill
    bytes of every conv and wgrad kernel instantiation, from ``-Xptxas -v``."""
    rows = []
    for chunk in build_log.split("Compiling entry function '")[1:]:
        m = _CONV_ENTRY.search(chunk.split("'", 1)[0])
        if not m:
            continue
        kind, elem, in_act, epi, vec, halo = m.groups()
        bf16 = elem != "f"
        name = (f"{kind}<{'bf16' if bf16 else 'f32'}, in_act={in_act}"
                + (f", {_EPILOGUES[int(epi)]}" if epi is not None else "")
                + f", vec={vec}, halo={halo}>")

        rows.append(dict(kernel=name, **ptxas_numbers(chunk),
                         dynamic_smem=lib.conv3x3_smem(kind == "wgrad_kernel", bf16)))
    return rows


def ptxas_numbers(chunk: str) -> dict:
    """Registers, static shared memory, stack and spill bytes of one kernel's entry in
    the ``-Xptxas -v`` report."""

    def num(pattern):
        m = re.search(pattern, chunk)
        return int(m.group(1)) if m else 0

    return dict(registers=num(r"Used (\d+) registers"), static_smem=num(r"(\d+) bytes smem"),
                stack=num(r"(\d+) bytes stack frame"),
                spill_stores=num(r"(\d+) bytes spill stores"),
                spill_loads=num(r"(\d+) bytes spill loads"))


_SEG_SMEM = {"seg_encoder_kernel": 0, "seg_decoder_kernel": 1, "seg_decoder_gproj_kernel": 2}
_SEG_ENTRY = re.compile(r"(seg_encoder_kernel|seg_decoder_kernel|seg_decoder_gproj_kernel)"
                        r"ILb([01])E|(seg_encoder_reduce_kernel)")


def sass_mma_counts(names) -> dict:
    """HGMMA (wgmma) and HMMA (mma.sync) instructions in the SASS of the kernels
    ``names`` (mangled) in the built library, from ``cuobjdump -sass -fun``."""
    from torch.utils.cpp_extension import CUDA_HOME

    from tdal_torch.ops.build import kernels

    sass = subprocess.run(
        [str(Path(CUDA_HOME) / "bin" / "cuobjdump"), "-sass", "-fun", ",".join(names),
         str(kernels().path)],
        capture_output=True, text=True, check=True, timeout=300,
    ).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = {"HGMMA": 0, "HMMA": 0}
        elif fn is not None:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\.", line):
                    counts[fn][op] += 1
    return counts


def seg_build_report(build_log: str, lib) -> list:
    """Registers, shared memory, spills and tensor-core instructions of every
    ``fused_pointnet.cu`` kernel instantiation."""
    chunks = {}
    for chunk in build_log.split("Compiling entry function '")[1:]:
        mangled = chunk.split("'", 1)[0]
        if _SEG_ENTRY.search(mangled):
            chunks[mangled] = chunk
    sass = sass_mma_counts(list(chunks))
    rows = []
    for mangled, chunk in chunks.items():
        kind, bf16, other = _SEG_ENTRY.search(mangled).groups()
        name = other or f"{kind}<{'bf16' if bf16 == '1' else 'f32'}>"

        mma = sass.get(mangled, {"HGMMA": 0, "HMMA": 0})
        rows.append(dict(kernel=name, **ptxas_numbers(chunk),
                         dynamic_smem=lib.seg_smem(_SEG_SMEM[kind]) if kind else 0,
                         hgmma=mma["HGMMA"], hmma=mma["HMMA"]))
    return rows


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median device time of one call, by CUDA events around each call."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_back_to_back(fn, reps: int = 20, warm: int = 3) -> float:
    """Device time of one call, by CUDA events around ``reps`` calls in a row, so that
    the host's work for one call overlaps the device's for the one before."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def encoder_work(b, n, cin):
    """(FLOP, bytes) of K1: each input read once, each output written once."""
    widths = (cin,) + ENC_WIDTHS
    macs = sum(a * c for a, c in zip(widths, widths[1:]))
    weights = sum(a * c + c for a, c in zip(widths, widths[1:]))
    return 2 * b * n * macs, 4 * (b * n * cin + weights + b * n * 64 + b * 1024)


def decoder_work(b, n):
    """(FLOP, bytes) of K2 in its least-work form: skip @ W0[:64] per point plus the
    per-set gmax @ W0[64:], then the 512-256-128-128-2 chain."""
    widths = (64,) + DEC_WIDTHS
    macs = sum(a * c for a, c in zip(widths, widths[1:]))
    weights = 1088 * 512 + sum(a * c for a, c in zip(widths[1:], widths[2:])) + sum(DEC_WIDTHS)
    return (2 * b * n * macs + 2 * b * 1024 * 512,
            4 * (b * n * 64 + b * 1024 + weights + b * n * 2))


def bound(work, bf16: bool):
    flops, nbytes = work
    t_ops, t_bytes = flops / PEAK_FLOPS[bf16], nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def rel_err(got, ref):
    err = float((got - ref).abs().max())
    return err, err / max(1.0, float(ref.abs().max()))


def rms_rel(got, ref) -> float:
    """RMS of the difference over the RMS of the reference."""
    return float((got - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt().clamp_min(1e-30))


def compare(gots, others, wants) -> dict:
    """A kernel's outputs ``gots``, and the same kernel's outputs in the other operand
    mode ``others``, against its twin's ``wants``; each error is the largest over the
    outputs."""
    errs = [rel_err(g, w) for g, w in zip(gots, wants)]
    return dict(
        max_abs_err=max(e for e, _ in errs), max_rel_err=max(r for _, r in errs),
        rms_err=max(rms_rel(g, w) for g, w in zip(gots, wants)),
        gap_max_rel=max(rel_err(o, w)[1] for o, w in zip(others, wants)),
        gap_rms=max(rms_rel(o, w) for o, w in zip(others, wants)),
    )


def phase_kernels(device) -> dict:
    """K1 and K2 against their twins at the production shapes, both operand modes.

    Each kernel's largest error against the twin of its own operand mode must be
    within ``TOL``, and its RMS error at most ``1 / MODE_MARGIN`` of the mode gap: the
    RMS error of the same kernel run in the other mode, on the same inputs, against
    that twin. So a kernel that ignored the operand mode would fail."""
    from tdal_torch.ops import fused_pointnet as fp
    from tdal_torch.ops.build import kernels
    from tdal_torch.pipeline.factories import random_pointnet_seg

    lib = kernels()
    results = {"fused_seg_encoder": {}, "fused_seg_decoder": {}}
    failures = []
    for shape_name, (b, n, cin) in SHAPES.items():
        seg = random_pointnet_seg(cin, seed=cin).to(device)
        x = torch.randn(b, n, cin, generator=torch.Generator().manual_seed(n)).to(device)
        with torch.inference_mode():
            folded = fp.fold_pointnet_seg_params(seg)
            enc_w, enc_b, dec = folded[0], folded[1], folded[2:]
            streams = {m: fp.seg_weight_streams(folded, m) for m in (False, True)}
            enc = {m: fp.fused_seg_encoder(x, enc_w, enc_b, m, streams[m][0])
                   for m in (False, True)}
            for bf16 in (False, True):
                mode = "bf16" if bf16 else "f32"
                skip, gmax = enc[bf16]
                logits = {m: fp.fused_seg_decoder(skip, gmax, *dec, m, streams[m][1])
                          for m in (False, True)}
                gproj = torch.empty(b, DEC_WIDTHS[0], device=device)
                out_s = torch.empty(b, n, 2, device=device)
                skip_s, gmax_s = torch.empty_like(skip), torch.empty_like(gmax)
                partial_s = torch.empty(b, -(-n // lib.encoder_tile()), ENC_WIDTHS[-1],
                                        device=device)
                torch.cuda.synchronize()
                skip_t, gmax_t = fp.fused_seg_encoder_plain(x, enc_w, enc_b, bf16)
                logits_t = fp.fused_seg_decoder_plain(skip, gmax, *dec, bf16)
                checks = {
                    "fused_seg_encoder": (compare(enc[bf16], enc[not bf16], (skip_t, gmax_t)),
                                          lambda: fp.fused_seg_encoder(x, enc_w, enc_b, bf16,
                                                                       streams[bf16][0]),
                                          lambda: fp.fused_seg_encoder_plain(x, enc_w, enc_b, bf16),
                                          encoder_work(b, n, cin)),
                    "fused_seg_decoder": (compare([logits[bf16]], [logits[not bf16]], [logits_t]),
                                          lambda: fp.fused_seg_decoder(skip, gmax, *dec, bf16,
                                                                       streams[bf16][1]),
                                          lambda: fp.fused_seg_decoder_plain(skip, gmax, *dec, bf16),
                                          decoder_work(b, n)),
                }
                del skip_t, gmax_t, logits_t, logits
                for name, (err, kernel, plain, work) in checks.items():
                    ms, plain_ms = time_ms(kernel), time_ms(plain)
                    decoder = name == "fused_seg_decoder"
                    ws = dec[0] if decoder else enc_w
                    bound_ms, bound_by = bound(work, bf16)
                    case = f"{shape_name} {mode}"
                    r = dict(**err, tol=TOL[bf16], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, gflop=work[0] / 1e9, tflops=work[0] / ms / 1e9,
                             bound_share=bound_ms / ms)
                    r["pack_ms"] = time_ms(lambda: fp.weight_stream(decoder, ws, bf16))
                    # the hand-written kernels alone (no host work): their launchers
                    # back to back
                    stream = streams[bf16][decoder]
                    if not decoder:
                        r["kernel_ms"] = time_back_to_back(lambda: lib.seg_encoder(
                            x, enc_w[0], list(enc_b), stream, skip_s, partial_s, gmax_s, bf16))
                    else:
                        r["kernel_ms"] = time_back_to_back(lambda: lib.seg_decoder(
                            skip, gmax, list(dec[1]), stream, dec[2], dec[3], gproj, out_s,
                            bf16))
                        r["gproj_ms"] = time_back_to_back(lambda: lib.seg_decoder_gproj(
                            gmax, stream, dec[1][0], gproj, bf16))
                    r["kernel_bound_share"] = bound_ms / r["kernel_ms"]
                    extra = (f"; the kernels alone {r['kernel_ms']:.3f} ms "
                             f"({100 * r['kernel_bound_share']:.0f}% of the bound), packing "
                             f"the weights {r['pack_ms']:.4f} ms")
                    if decoder:
                        extra += (f", of the kernels gproj {r['gproj_ms']:.4f} ms "
                                  f"({100 * r['gproj_ms'] / r['kernel_ms']:.1f}%)")
                    results[name][case] = r
                    log(f"  {name} {shape_name} B={b} N={n} Cin={cin} {mode}: "
                        f"max abs err {err['max_abs_err']:.3e}, rel {err['max_rel_err']:.3e} "
                        f"(tol {TOL[bf16]:.0e}), RMS {err['rms_err']:.3e}; the other mode's "
                        f"kernel against this twin: rel {err['gap_max_rel']:.3e}, "
                        f"RMS {err['gap_rms']:.3e}; kernel {ms:.3f} ms "
                        f"({r['tflops']:.1f} TFLOP/s, {100 * r['bound_share']:.0f}% of the "
                        f"bound; the earlier f32-FMA kernel's recorded "
                        f"{FMA_KERNEL_MS[name][case]:.3f} ms), twin {plain_ms:.3f} ms, "
                        f"bound {bound_ms:.3f} ms ({bound_by}){extra}")
                    if not (err["max_rel_err"] <= TOL[bf16]
                            and MODE_MARGIN * err["rms_err"] <= err["gap_rms"]):
                        failures.append(f"{name} {shape_name} {mode}: {json.dumps(err)}")
        del seg, x, enc, streams
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("kernels disagree with their twins: " + "; ".join(failures))
    return results


def build_segment(root: Path):
    """The synthetic segment, its AnnoStore, fabricated detections and det_annos."""
    from tdal_torch.data.synthetic import fabricate_detections, make_synthetic_dataset
    from tdal_torch.data.waymo_schema import AnnoStore, reorganize_info
    from tdal_torch.pipeline.track_extraction import create_pd_detection

    infos, scenes = make_synthetic_dataset(root / "segment", **SEGMENT)
    info_map = reorganize_info(infos)
    annos = AnnoStore(info_map)
    detections = fabricate_detections(scenes, annos)
    det_annos, _ = create_pd_detection(detections, info_map, root / "det", tracking=False)
    return infos, info_map, annos, detections, det_annos


def reference_check(name, model, inputs_fn, kind, make_dataset, device, n=16):
    """One batch of ``n`` sets through the labeler on the card (K1+K2) and through a
    CPU copy (plain layers): seg logits within 1e-4 of max(1, |logit|); decoded
    boxes within 1e-3 wherever the seg mask and both argmaxes agree, and every set
    where they differ has a decision margin under 1e-3 on the CPU side."""
    from tdal_torch.data.track_datasets import batch_iterator
    from tdal_torch.pipeline.labeler_run import decode_final_boxes_np

    batch = next(batch_iterator(make_dataset(), n, pad_to_full=True))
    inputs = [torch.as_tensor(np.asarray(a)) for a in inputs_fn(batch)]
    cpu_model = copy.deepcopy(model).cpu()
    with torch.inference_mode():
        out = {k: v.cpu() for k, v in model(*(a.to(device) for a in inputs)).items()}
        ref = cpu_model(*inputs)
    _, logit_rel = rel_err(out["logits"], ref["logits"])
    if not logit_rel <= 1e-4:
        raise AssertionError(f"{name}: seg logits differ from the CPU reference by {logit_rel}")
    init_box = np.asarray(batch["init_box"])
    host = lambda o: {k: v.numpy() for k, v in o.items() if v.dtype != torch.bool}  # noqa: E731
    got = decode_final_boxes_np(host(out), init_box, kind)
    want = decode_final_boxes_np(host(ref), init_box, kind)
    agree = (out["mask"] == ref["mask"]).all(dim=1)
    for k in ("heading_scores", "size_scores"):
        agree &= out[k].argmax(1) == ref[k].argmax(1)
    agree = agree.numpy()
    if not np.isfinite(got).all() or got.shape != (n, 7):
        raise AssertionError(f"{name}: boxes not finite or of shape {got.shape}")
    box_err = float(np.abs(got - want)[agree].max()) if agree.any() else 0.0
    if not box_err <= 1e-3:
        raise AssertionError(f"{name}: boxes differ from the CPU reference by {box_err}")
    lg = ref["logits"]
    seg_margin = (lg[..., 1] - lg[..., 0]).abs().amin(dim=1).numpy()
    for i in np.flatnonzero(~agree):
        gaps = [float(seg_margin[i])]
        for k in ("heading_scores", "size_scores"):
            top = ref[k][i].sort().values
            gaps.append(float(top[-1] - top[-2]))
        if not min(gaps) < 1e-3:
            raise AssertionError(f"{name}: set {i} decided otherwise with margins {gaps}")
    log(f"  {name}: seg logits rel err {logit_rel:.2e}; boxes max abs err {box_err:.2e} on "
        f"{int(agree.sum())}/{n} sets whose decisions agree (the rest sit within 1e-3 of a tie)")


def phase_chain(device) -> dict:
    from tdal_torch.data.track_datasets import DynamicTrackDataset, StaticTrackDataset
    from tdal_torch.ops import fused_pointnet as fp
    from tdal_torch.pipeline.factories import make_labeler
    from tdal_torch.pipeline.offboard import label_chain

    logger = logging.getLogger("chip_smoke")
    labelers = tuple((m, i, k) for m, _, i, k in (make_labeler("one_box_est", seed=0),
                                                   make_labeler("dynamic", seed=1)))
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        infos, info_map, annos, detections, det_annos = build_segment(root)
        log(f"  segment written and detections fabricated in {time.perf_counter() - t0:.2f} s")

        def chain(out):
            """Stages 2-6 through the port's driver on the default device (CUDA)."""
            return label_chain(detections, info_map, annos, labelers, out, logger,
                               score_thresh=0.1, npoints_static=NPOINTS_STATIC,
                               npoints_dynamic=NPOINTS_DYNAMIC, predict_batch=PREDICT_BATCH,
                               det_annos=det_annos)

        chain(root / "warm")
        torch.cuda.synchronize()
        for k in fp.launches:
            fp.launches[k] = 0
        t0 = time.perf_counter()
        res = chain(root / "timed")
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = dict(fp.launches)

        counts = res["counts"]
        stages = ", ".join(f"{k} {v:.3f} s" for k, v in res["stage_s"].items())
        log(f"  stages 2-6: {stages}; total {total:.3f} s, "
            f"{SEGMENT['n_frames'] / total:.2f} frames/s")
        log(f"  counts: {json.dumps(counts)}")
        log(f"  kernel launches in the timed pass: {launches}")
        if not (counts["static_boxes_labeled"] > 0 and counts["dynamic_boxes_labeled"] > 0):
            raise AssertionError(f"a labeler labeled nothing: {counts}")
        for name, n in launches.items():
            if n != counts["predict_batches"]:
                raise AssertionError(
                    f"{name}: {n} launches for {counts['predict_batches']} predict batches")
        for kind, b in res["boxes"].items():
            if not np.isfinite(b).all() or b.shape[1] != 7:
                raise AssertionError(f"{kind} boxes not finite or not (n, 7): {b.shape}")

        (s_model, s_inputs, s_kind), (d_model, d_inputs, d_kind) = labelers
        reference_check("static labeler", s_model, s_inputs, s_kind,
                        lambda: StaticTrackDataset(res["static_labeled"], annos,
                                                   npoints=NPOINTS_STATIC, seed=0), device)
        reference_check("dynamic labeler", d_model, d_inputs, d_kind,
                        lambda: DynamicTrackDataset(res["track_dynamic"], annos,
                                                    npoints=NPOINTS_DYNAMIC, seed=0), device)
    return dict(launches=launches, total_s=total, **counts, stage_s=res["stage_s"])


# ---------------------------------------------------------------------------
# phase 5: the 3x3 conv kernels K3, K4, K5/K6
# ---------------------------------------------------------------------------

CONV_SOURCE = "tdal_torch/ops/csrc/conv3x3.cu"
CONV_REPLACES = {
    "conv3x3_fwd_stats": "tdal/ops/pallas_conv.py:147",
    "conv3x3_fwd": "tdal/ops/pallas_conv.py:267",
    "conv3x3_wgrad": "tdal/ops/pallas_conv.py:519",
    "conv3x3_dgrad_act": "tdal/ops/pallas_conv.py:375",
}
PROTO = dict(name="conv3x3", replaces="benchmarks/proto_pallas_conv.py:24",
             shape="rpn stage 1", dtype=torch.bfloat16)
# (B, H, W, C, Co): the stride-1 3x3 conv sites of the Waymo PP train step, and a
# ragged image (with positive input shifts: a halo that leaked relu(t) moves its border)
CONV_SHAPES = {
    "rpn stage 1": (4, 468, 468, 64, 64),
    "rpn stage 2": (4, 234, 234, 128, 128),
    "rpn stage 3": (4, 117, 117, 256, 256),
    "head shared": (4, 468, 468, 384, 64),
    "head branch": (4, 468, 468, 64, 320),
    "ragged halo": (2, 37, 41, 48, 80),
    # the VoxelNet RPN's stride-1 sites at 188^2 and 94^2, and its head's shared conv
    "vn rpn stage 1": (4, 188, 188, 128, 128),
    "vn rpn stage 2": (4, 94, 94, 256, 256),
    "vn head shared": (4, 188, 188, 512, 64),
}
CONV_MAIN = "rpn stage 1 f32 in_act"  # the kernels line's case: a chained RPN layer
# max |kernel - twin| / max(1, max |twin|): f32 outputs and every f32 accumulator
# (bf16 moments and wgrad: the same exact products summed in another order) 1e-5;
# bf16 y and dgrad 8e-3, one bf16 rounding step at the largest value (2^-7), which a
# summation-order difference can flip
CONV_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (8e-3, 1e-5)}
# K7's ds and dt: each channel's error over the sum of its absolute terms (sum |dxh*x|,
# sum |dxh|), at most the accumulator tolerance: f32 sums of the same terms in another
# order, and a signed sum can be far smaller than its terms


def conv_case_inputs(shape_name, dtype, device) -> dict:
    """Phase 5's inputs for one shape and operand mode, from a seeded generator."""
    b, h, w, c, co = CONV_SHAPES[shape_name]
    g = torch.Generator().manual_seed(b * h + c)
    x = torch.randn(b, h, w, c, generator=g).to(dtype).to(device)
    wt = (torch.randn(3, 3, c, co, generator=g) / (3 * c ** 0.5)).to(dtype).to(device)
    bias = torch.randn(co, generator=g).to(device)
    s = (0.5 + torch.rand(c, generator=g)).to(device)
    t = (0.5 + torch.rand(c, generator=g) if shape_name == "ragged halo"
         else torch.randn(c, generator=g)).to(device)
    gy = torch.randn(b, h, w, co, generator=g).to(dtype).to(device)
    return dict(x=x, wt=wt, bias=bias, s=s, t=t, gy=gy, x_cl=x.permute(0, 3, 1, 2),
                gy_cl=gy.permute(0, 3, 1, 2), w_oihw=wt.permute(3, 2, 0, 1).contiguous())


def library_calls(inp, shape_name, mode) -> dict:
    """The cuDNN call computing each kernel's function on phase 5's inputs (TF32 off in
    f32); K7's is ``conv2d_input`` + the torch epilogue, P's a bias-free ``conv2d``."""
    from torch.nn.grad import conv2d_input, conv2d_weight

    x, x_cl, gy_cl, w_oihw = inp["x"], inp["x_cl"], inp["gy_cl"], inp["w_oihw"]
    calls = {
        "conv3x3_fwd_stats": lambda: torch.nn.functional.conv2d(
            x_cl, w_oihw, inp["bias"].to(x.dtype), padding=1),
        "conv3x3_fwd": lambda: conv2d_input(x_cl.shape, w_oihw, gy_cl, padding=1),
        "conv3x3_wgrad": lambda: conv2d_weight(x_cl, w_oihw.shape, gy_cl, padding=1),
    }
    if not shape_name.endswith("head shared"):  # the shared conv is never chained
        calls["conv3x3_dgrad_act"] = lambda: dgrad_act_epilogue(
            conv2d_input(x_cl.shape, w_oihw, gy_cl, padding=1).permute(0, 2, 3, 1), x,
            inp["s"], inp["t"])
    if shape_name == PROTO["shape"] and mode == "bf16":
        calls[PROTO["name"]] = lambda: torch.nn.functional.conv2d(x_cl, w_oihw, padding=1)
    return calls


def library_times(device) -> dict:
    """Every phase 5 library call's time with ``torch.backends.cudnn.benchmark`` on, so
    cuDNN picks its fastest algorithm by trying them: the yardstick is cuDNN's best,
    not its heuristic's pick. Run in a process of its own (``--library-times``): cuDNN
    keeps the plans it found for a shape and uses them with benchmark off as well, so
    in this process they would reach the train and inference steps of phases 6-7."""
    torch.backends.cudnn.benchmark = True
    out = {}
    for shape_name in CONV_SHAPES:
        for dtype, mode in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            inp = conv_case_inputs(shape_name, dtype, device)
            for name, fn in library_calls(inp, shape_name, mode).items():
                out[f"{name}|{shape_name} {mode}"] = time_ms(fn, reps=10, warm=2)
            del inp
            torch.cuda.empty_cache()
    return out


class LibraryTimes:
    """``library_times`` in a child process (this script with ``--library-times``),
    started while the parent leaves the card idle (as it waits for the CPU lane) and
    waited for before the parent uses the card again; ``stop`` ends it if it still
    runs."""

    def __init__(self):
        self.proc = self.ms = self.seconds = None

    def start(self):
        self.out, self.err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--library-times"],
            stdout=self.out, stderr=self.err, text=True)
        return self.wait

    def wait(self):
        rc = self.proc.wait(timeout=900)
        self.seconds = time.perf_counter() - self.t0
        self.out.seek(0)
        self.err.seek(0)
        out, err = self.out.read(), self.err.read()
        if rc != 0:
            raise RuntimeError(f"the library timing process failed:\n{out[-2000:]}"
                               f"\n{err[-2000:]}")
        self.ms = json.loads(out.strip().splitlines()[-1])
        log(f"  cuDNN's times in benchmark mode, in a process of their own that ran while "
            f"this one waited for the CPU lane ({self.seconds:.1f} s)")
        return self.ms

    def stop(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def attach_library_times(results: dict, lib_ms: dict):
    """Phase 5's readings get their cuDNN time (``library_ms``), each logged beside the
    kernel's."""
    for name, by_case in results.items():
        for case, r in by_case.items():
            mode_case = case.removesuffix(" in_act")
            r["library_ms"] = lib_ms[f"{name}|{mode_case}"]
            log(f"  {name} {case}: kernel {r['ms']:.3f} ms, library {r['library_ms']:.3f} ms "
                f"({r['library_ms'] / r['ms']:.2f}x), twin {r['plain_ms']:.3f} ms")


def dgrad_act_scales(gy, wt, x, s, t, halo=(0, 0)):
    """(2, C): sum |dxh * x| and sum |dxh| per channel, from the twin's arithmetic."""
    from tdal_torch.ops import conv3x3 as cv

    dxh = cv._conv_f32(gy.float(), wt.float(), halo) * (x.float() * s + t > 0)
    return torch.stack([(dxh * x.float()).abs().sum(dim=(0, 1, 2)),
                        dxh.abs().sum(dim=(0, 1, 2))])


def dgrad_act_unfused(gy, wt, x, s, t):
    """The in_act dgrad as two passes: K4 (the dgrad, rounded to the working type),
    then the mask, dx and the sums in torch (the route K7 replaced)."""
    from tdal_torch.ops import conv3x3 as cv

    dxhat = cv.conv3x3_fwd(gy, wt, torch.zeros(x.shape[-1], device=x.device))
    return dgrad_act_epilogue(dxhat, x, s, t)


def dgrad_act_epilogue(dxhat, x, s, t):
    dxh = dxhat.float() * (x.float() * s + t > 0)
    return (dxh * s).to(x.dtype), torch.stack([(dxh * x.float()).sum(dim=(0, 1, 2)),
                                               dxh.sum(dim=(0, 1, 2))])


def conv_work(name, b, h, w, c, co, itemsize):
    """(FLOP, bytes) of one conv kernel call: each input read once, each output
    written once (statistics, bias and affine vectors included)."""
    flops = 2 * b * h * w * 9 * c * co
    weights = 9 * c * co * itemsize
    if name == "conv3x3_fwd_stats":
        nbytes = b * h * w * (c + co) * itemsize + weights + 4 * (2 * c + co + 2 * co)
    elif name == "conv3x3_fwd":  # as the dgrad: gy (co channels) -> dx (c channels)
        nbytes = b * h * w * (co + c) * itemsize + weights + 4 * c
    elif name == "conv3x3_dgrad_act":  # gy, x -> dx; s, t -> (2, c) sums
        nbytes = b * h * w * (co + 2 * c) * itemsize + weights + 4 * (2 * c + 2 * c)
    elif name == "conv3x3":  # the forward: x -> y
        nbytes = b * h * w * (c + co) * itemsize + weights
    else:
        nbytes = b * h * w * (c + co) * itemsize + 4 * (9 * c * co + 2 * c)
    return flops, nbytes


def conv_reading(name, case, errs, ms, plain_ms, work, bf16, **extra):
    """One kernel case's result: errors, times, bound; logged (cuDNN's time comes later,
    ``attach_library_times``)."""
    bound_ms, bound_by = bound(work, bf16)
    r = dict(max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs),
             tol=[e[2] for e in errs], ms=ms, plain_ms=plain_ms, library_ms=None,
             bound_ms=bound_ms, bound_by=bound_by, gflop=work[0] / 1e9,
             tflops=work[0] / ms / 1e9, **extra)
    more = "".join(f", {k.replace('_ms', '')} {v:.3f} ms" for k, v in extra.items()
                   if k.endswith("_ms"))
    log(f"  {name} {case}: max abs err {r['max_abs_err']:.3e}, rel {r['max_rel_err']:.3e}; "
        f"kernel {ms:.3f} ms ({r['tflops']:.1f} TFLOP/s), twin {plain_ms:.3f} ms"
        f"{more}, bound {bound_ms:.3f} ms ({bound_by})")
    return r


def phase_conv(device) -> dict:
    """K3, K4 (dgrad), K5/K6 and K7 against their twins at the production shapes, and
    K4 as the benchmark prototype's ``conv3x3``; cuDNN's times are attached later
    (``attach_library_times``)."""
    from tdal_torch.ops import conv3x3 as cv

    results = {k: {} for k in (*CONV_REPLACES, PROTO["name"])}
    failures = []
    for shape_name, (b, h, w, c, co) in CONV_SHAPES.items():
        for dtype, mode in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            inp = conv_case_inputs(shape_name, dtype, device)
            x, wt, bias, s, t, gy = (inp[k] for k in ("x", "wt", "bias", "s", "t", "gy"))
            wf = cv._flip_swap(wt)
            zero_c = torch.zeros(c, device=device)
            tol_y, tol_acc = CONV_TOL[dtype]
            bf16 = dtype == torch.bfloat16
            for in_act in (False, True):
                case = f"{shape_name} {mode}" + (" in_act" if in_act else "")
                kernel = {
                    "conv3x3_fwd_stats": lambda: cv.conv3x3_fwd_stats(x, wt, bias, s, t, in_act),
                    "conv3x3_fwd": lambda: cv.conv3x3_fwd(gy, wf, zero_c),
                    "conv3x3_wgrad": lambda: cv.conv3x3_wgrad(x, gy, s, t, in_act),
                }
                plain = {
                    "conv3x3_fwd_stats": lambda: cv.conv3x3_fwd_stats_plain(
                        x, wt, bias, s, t, in_act),
                    "conv3x3_fwd": lambda: cv.conv3x3_fwd_plain(gy, wf, zero_c),
                    "conv3x3_wgrad": lambda: cv.conv3x3_wgrad_plain(x, gy, s, t, in_act),
                }
                for name in kernel:
                    got, want = kernel[name](), plain[name]()
                    torch.cuda.synchronize()
                    if name == "conv3x3_fwd_stats":
                        pairs = [(got[0], want[0], tol_y), (got[1], want[1], tol_acc)]
                    else:
                        pairs = [(got, want, tol_y if name == "conv3x3_fwd" else tol_acc)]
                    errs = [(*rel_err(a.float(), r.float()), tol) for a, r, tol in pairs]
                    del got, want
                    r = results[name][case] = conv_reading(
                        name, f"{case} B={b} {h}x{w} {c}->{co}", errs,
                        time_ms(kernel[name], reps=10, warm=2),
                        time_ms(plain[name], reps=5, warm=1),
                        conv_work(name, b, h, w, c, co, x.element_size()), bf16)
                    if not all(e[1] <= e[2] for e in errs):
                        failures.append(f"{name} {case}: {json.dumps(r)}")
                if in_act and not shape_name.endswith("head shared"):  # K7: chained dgrad
                    name = "conv3x3_dgrad_act"
                    dx, st = cv.conv3x3_dgrad_act(gy, wf, x, s, t)
                    dx_t, st_t = cv.conv3x3_dgrad_act_plain(gy, wf, x, s, t)
                    torch.cuda.synchronize()
                    scale = dgrad_act_scales(gy, wf, x, s, t)
                    errs = [(*rel_err(dx.float(), dx_t.float()), tol_y),
                            (float((st - st_t).abs().max()),
                             float(((st - st_t).abs() / scale.clamp_min(1e-30)).max()),
                             tol_acc)]
                    del dx, st, dx_t, st_t, scale
                    r = results[name][case] = conv_reading(
                        name, f"{case} B={b} {h}x{w} {co}->{c}", errs,
                        time_ms(lambda: cv.conv3x3_dgrad_act(gy, wf, x, s, t), reps=10, warm=2),
                        time_ms(lambda: cv.conv3x3_dgrad_act_plain(gy, wf, x, s, t), reps=5,
                                warm=1),
                        conv_work(name, b, h, w, c, co, x.element_size()), bf16,
                        unfused_ms=time_ms(lambda: dgrad_act_unfused(gy, wf, x, s, t),
                                           reps=10, warm=2),
                        library="cuDNN conv2d_input + the torch epilogue")
                    if not all(e[1] <= e[2] for e in errs):
                        failures.append(f"{name} {case}: {json.dumps(r)}")
            if shape_name == PROTO["shape"] and dtype == PROTO["dtype"]:
                # tdal's benchmark prototype: a bias-free conv, which is K4 with shift 0
                name, case = PROTO["name"], f"{shape_name} {mode}"
                zero_co = torch.zeros(co, device=device)
                with torch.no_grad():
                    y, y_t = cv.conv3x3(x, wt), cv.conv3x3_fwd_plain(x, wt, zero_co)
                    torch.cuda.synchronize()
                    errs = [(*rel_err(y.float(), y_t.float()), tol_y)]
                    del y, y_t
                    r = results[name][case] = conv_reading(
                        name, f"{case} B={b} {h}x{w} {c}->{co}", errs,
                        time_ms(lambda: cv.conv3x3(x, wt), reps=10, warm=2),
                        time_ms(lambda: cv.conv3x3_fwd_plain(x, wt, zero_co), reps=5, warm=1),
                        conv_work(name, b, h, w, c, co, x.element_size()), bf16)
                if not all(e[1] <= e[2] for e in errs):
                    failures.append(f"{name} {case}: {json.dumps(r)}")
            del inp, x, wt, gy, wf
            torch.cuda.empty_cache()
    if failures:
        raise AssertionError("conv kernels disagree with their twins: " + "; ".join(failures))
    return results, conv_halo_times(device)


def conv_halo_times(device) -> dict:
    """The row halo forms (halo (1, 1): a slab with a neighbour above and below) at the
    kernels line's case (``CONV_MAIN``: B=4, 468 own rows of 468, 64->64, f32, input
    affine on), each kernel's ms beside its whole-image call on the same output rows.
    Each is held against the whole-image kernel on the 470-row map whose inner 468 rows
    it computes: the same per-pixel sums, so y and dx to 1e-5 of max(1, |x|) (1e-6 was
    seen), dw (other tiles, another summation order) to 1e-5."""
    from tdal_torch.ops import conv3x3 as cv

    shape = CONV_SHAPES[CONV_MAIN.split(" f32")[0]]
    b, h, w, c, co = shape
    g = torch.Generator().manual_seed(7)
    big = lambda *sh: torch.randn(*sh, generator=g).to(device)  # noqa: E731
    x, gy = big(b, h + 2, w, c), big(b, h + 2, w, co)
    wt = (torch.randn(3, 3, c, co, generator=g) / (3 * c ** 0.5)).to(device)
    bias, s, t = big(co), (0.5 + torch.rand(c, generator=g)).to(device), big(c)
    wf, zero = cv._flip_swap(wt), torch.zeros(c, device=device)
    inner = lambda a: a[:, 1:-1].contiguous()  # noqa: E731
    xo, go = inner(x), inner(gy)
    g_pad = torch.nn.functional.pad(go, (0, 0, 0, 0, 1, 1))  # zero cotangent at the halo
    calls = {  # name -> (halo form, whole-image call on the own rows, reference pair)
        "conv3x3_fwd_stats": (lambda: cv.conv3x3_fwd_stats(x, wt, bias, s, t, True, (1, 1)),
                              lambda: cv.conv3x3_fwd_stats(xo, wt, bias, s, t, True),
                              lambda: inner(cv.conv3x3_fwd_stats(x, wt, bias, s, t, True)[0])),
        "conv3x3_fwd": (lambda: cv.conv3x3_fwd(gy, wf, zero, halo=(1, 1)),
                        lambda: cv.conv3x3_fwd(go, wf, zero),
                        lambda: inner(cv.conv3x3_fwd(gy, wf, zero))),
        "conv3x3_wgrad": (lambda: cv.conv3x3_wgrad(x, go, s, t, True, (1, 1)),
                          lambda: cv.conv3x3_wgrad(xo, go, s, t, True),
                          lambda: cv.conv3x3_wgrad(x, g_pad, s, t, True)),
        "conv3x3_dgrad_act": (lambda: cv.conv3x3_dgrad_act(gy, wf, xo, s, t, (1, 1)),
                              lambda: cv.conv3x3_dgrad_act(go, wf, xo, s, t),
                              lambda: inner(cv.conv3x3_dgrad_act(
                                  gy, wf, torch.nn.functional.pad(xo, (0, 0, 0, 0, 1, 1)),
                                  s, t)[0])),
    }
    out, failures = {}, []
    for name, (halo_call, whole_call, ref_call) in calls.items():
        got, ref = halo_call(), ref_call()
        got = got[0] if isinstance(got, tuple) else got
        err = rel_err(got.float(), ref.float())[1]
        out[name] = dict(halo_ms=time_ms(halo_call, reps=10, warm=2),
                         whole_ms=time_ms(whole_call, reps=10, warm=2), rel_err=err)
        log(f"  {name} {CONV_MAIN} in the halo form (1, 1): {out[name]['halo_ms']:.3f} ms "
            f"beside {out[name]['whole_ms']:.3f} ms for the whole-image call on the same "
            f"{h} rows; against the whole-image kernel on {h + 2} rows {err:.3e} (tol 1e-5)")
        if not err <= 1e-5:
            failures.append(f"{name}: {err:.3e}")
        del got, ref
    if failures:
        raise AssertionError("the halo forms disagree with the whole-image kernels: "
                             + "; ".join(failures))
    return out


# phase 14's stride-1 conv sites, which run on a rank's row slab: phase 5's PP shapes
SLAB_SHAPES = ("rpn stage 1", "rpn stage 2", "rpn stage 3", "head shared", "head branch")


def conv_halo_twin_checks(device) -> dict:
    """Each kernel's halo form against its twin with the same halo, on the same card
    tensors, at phase 14's conv sites on each rank's row slab: phase 5's PP shapes with
    H split as phase 14 splits it over ``SP_WORLD`` ranks (the coarsest level's rows,
    scaled to each level: halo (0, 1) on the first rank, (1, 0) on the last), f32,
    positive input shifts (relu(t) leaked into the padding at the map's own edge would
    move its edge rows). K3 and K5/K6 with the input affine on and off, K4 as the dgrad
    (shift 0) and with scale + ReLU, K7 (not at the never-chained shared conv). Held as
    phase 5 holds the whole-image kernels (``CONV_TOL``); a mismatch raises. Returns the
    worst relative error of each kernel, by shape and rank."""
    from tdal_torch.ops import conv3x3 as cv
    from tdal_torch.parallel.mesh import row_ranges

    coarse = CONV_SHAPES["rpn stage 3"][1]
    tol_y, tol_acc = CONV_TOL[torch.float32]
    out, failures = {}, []
    for shape_name in SLAB_SHAPES:
        b, h, w, c, co = CONV_SHAPES[shape_name]
        ranges = [(a * h // coarse, e * h // coarse) for a, e in row_ranges(coarse, SP_WORLD)]
        for r, (a, e) in enumerate(ranges):
            halo, n = (int(r > 0), int(r < len(ranges) - 1)), e - a
            g = torch.Generator().manual_seed(h + c + r)
            rnd = lambda *sh: torch.randn(*sh, generator=g).to(device)  # noqa: E731
            pos = lambda k: (0.5 + torch.rand(k, generator=g)).to(device)  # noqa: E731
            x, gh = rnd(b, sum(halo) + n, w, c), rnd(b, sum(halo) + n, w, co)
            xo = x[:, halo[0] : halo[0] + n].contiguous()
            go = gh[:, halo[0] : halo[0] + n].contiguous()
            wt = (torch.randn(3, 3, c, co, generator=g) / (3 * c ** 0.5)).to(device)
            wf, zero_c = cv._flip_swap(wt), torch.zeros(c, device=device)
            bias, scale, s, t = rnd(co), pos(co), pos(c), pos(c)
            cases = {}  # kernel -> [(kernel's out, twin's out, tol)]
            for act in (False, True):
                (y, st), (y_t, st_t) = (
                    f(x, wt, bias, s, t, act, halo)
                    for f in (cv.conv3x3_fwd_stats, cv.conv3x3_fwd_stats_plain))
                cases.setdefault("K3", []).extend([(y, y_t, tol_y), (st, st_t, tol_acc)])
                cases.setdefault("K5/K6", []).append(
                    tuple(f(x, go, s, t, act, halo) for f in (
                        cv.conv3x3_wgrad, cv.conv3x3_wgrad_plain)) + (tol_acc,))
            cases["K4"] = [
                (cv.conv3x3_fwd(gh, wf, zero_c, halo=halo),
                 cv.conv3x3_fwd_plain(gh, wf, zero_c, halo=halo), tol_y),
                (cv.conv3x3_fwd(x, wt, bias, scale, True, halo),
                 cv.conv3x3_fwd_plain(x, wt, bias, scale, True, halo), tol_y)]
            errs = {k: [(*rel_err(got.float(), want.float()), tol) for got, want, tol in v]
                    for k, v in cases.items()}
            if not shape_name.endswith("head shared"):  # K7: chained sites only
                (dx, st), (dx_t, st_t) = (f(gh, wf, xo, s, t, halo) for f in (
                    cv.conv3x3_dgrad_act, cv.conv3x3_dgrad_act_plain))
                d = (st - st_t).abs()
                errs["K7"] = [(*rel_err(dx, dx_t), tol_y), (
                    float(d.max()), float((d / dgrad_act_scales(
                        gh, wf, xo, s, t, halo).clamp_min(1e-30)).max()), tol_acc)]
            torch.cuda.synchronize()
            worst = {k: max(e[1] / e[2] for e in v) for k, v in errs.items()}
            out[f"{shape_name} rank {r}"] = dict(
                rows=n, of=h, halo=list(halo), channels=[c, co],
                rel_err={k: max(e[1] for e in v) for k, v in errs.items()})
            log(f"    {shape_name}, rank {r}: {n} own rows of {h}, halo {halo}, {c}->{co}: "
                "worst share of the tolerance " + ", ".join(
                    f"{k} {v:.3f}" for k, v in worst.items()))
            failures += [f"{shape_name} rank {r} {k}: {v:.3f}" for k, v in worst.items()
                         if not v <= 1]
            del x, gh, xo, go, cases, errs
            torch.cuda.empty_cache()
    if failures:
        raise AssertionError("the halo forms disagree with their twins: " + "; ".join(failures))
    return out


# ---------------------------------------------------------------------------
# phase 6: PointPillars training on the Waymo config
# ---------------------------------------------------------------------------

PP_CONFIG = Path("configs/waymo/pp/waymo_centerpoint_pp_two_pfn_stride1_3x.py")
PP_DATA = dict(n_scenes=1, n_frames=8, seed=0, n_static=10, n_dynamic=10,
               points_per_object=256, n_background=150000)
PP_BATCH, PP_WARM_EPOCHS, PP_TIMED_EPOCHS = 4, 1, 2
# the epoch before the warm one, run under ``deterministic``: its end is the weights that
# the card-vs-CPU step check and phase 10 (a) start from
PP_SNAPSHOT_EPOCHS = 1
# the card-vs-CPU step check's batch: the first two frames of the timed batch (its six
# CPU steps at batch 4 took 406-527 s of the script's 1200)
PP_CHECK_BATCH = 2
PP_TIMED = PP_TIMED_EPOCHS * PP_DATA["n_frames"] // PP_BATCH  # steps
# (shape of phase 5, input affine on, sites per step): each stage's stride-1 entry
# (stage 1) or first layer after the strided entry takes no input affine
PP_SITE_CASES = [("rpn stage 1", False, 1), ("rpn stage 1", True, 3),
                 ("rpn stage 2", False, 1), ("rpn stage 2", True, 4),
                 ("rpn stage 3", False, 1), ("rpn stage 3", True, 4),
                 ("head shared", False, 1), ("head branch", True, 1)]
PP_SITES = sum(n for _, _, n in PP_SITE_CASES)
PP_CHAINED = sum(n for _, act, n in PP_SITE_CASES if act)
# launches per train step: the dgrad is K7 at the chained sites and K4 at the others
PP_LAUNCHES = {"conv3x3_fwd_stats": PP_SITES, "conv3x3_fwd": PP_SITES - PP_CHAINED,
               "conv3x3_dgrad_act": PP_CHAINED, "conv3x3_wgrad": PP_SITES}
GRAD_NOISE_MARGIN = 8  # gradients within 8x the measured noise floor
# relative change of every weight for the noise floor: about the f32 rounding of a
# dot product over 9 * C = 576..3456 terms in another order (sqrt(n) * 2^-24)
ULP_PERTURBATION = 2.0**-19


@contextlib.contextmanager
def deterministic():
    """Within the block: cuDNN's deterministic algorithms (no benchmark search) and
    torch's deterministic mode, warning where an op has no deterministic version. Yields
    a list that, at the block's end, holds the first line of each such warning (cuBLAS's
    note on ``CUBLAS_WORKSPACE_CONFIG`` left out: its GEMMs repeat their bits on one
    stream). The settings before the block come back after it."""
    before = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
              torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    named = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield named
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before[:2]
            torch.use_deterministic_algorithms(before[2], warn_only=before[3])
            named.extend(sorted({str(w.message).splitlines()[0] for w in caught
                                 if "determinis" in str(w.message)
                                 and "CUBLAS_WORKSPACE_CONFIG" not in str(w.message)}))


def library_conv_probes(m, captured):
    """Forward hooks on the head's cuDNN (or oneDNN) convs whose f32 weight gradient
    ``step_with_grads`` holds against float64: each SepHead's final block-diagonal conv
    and, in a deformable head, the heatmap branch's two convs and the two 1x1 offset
    convs. Fills ``captured`` in the forward; returns, per conv, (parameter name, weight,
    mask or None, padding, key of its input in ``captured``, keys of the tensors whose
    concatenation is its output)."""
    from tdal_torch.models.dcn import DCNSepHead

    def keep(key, fn):
        return lambda mod, args, out: captured.__setitem__(key, fn(args, out))

    probes = []
    for t, task in enumerate(m.head.tasks):
        pre = f"head.tasks.{t}."
        sep = task.reg if isinstance(task, DCNSepHead) else task
        sp = pre + ("reg." if sep is not task else "")
        sep.branch_convbn0.register_forward_hook(keep(sp + "in", lambda a, o: o.detach()))
        probes.append((sp + "final_conv_weight", sep.final_conv_weight, sep.final_conv_mask,
                       1, sp + "in", [f"{t}/{n}" for n in sep.names]))
        if sep is task:
            continue
        task.cls_bn.register_forward_hook(keep(pre + "cls_out", lambda a, o: a[0]))
        task.cls_bn.register_forward_hook(keep(pre + "hm_in",
                                               lambda a, o: torch.relu(o).detach()))
        probes += [(pre + "cls_conv.weight", task.cls_conv.weight, None, 1,
                    pre + "center", [pre + "cls_out"]),
                   (pre + "hm_conv.weight", task.hm_conv.weight, None, 1, pre + "hm_in",
                    [f"{t}/hm"])]
        for name in ("center_adapt", "reg_adapt"):
            fa = getattr(task, name)
            fa.deform.register_forward_hook(keep(f"{pre}{name}.x", lambda a, o: a[0].detach()))
            fa.deform.register_forward_hook(keep(f"{pre}{name}.offsets", lambda a, o: a[1]))
            probes.append((f"{pre}{name}.offset.weight", fa.offset.weight, None, 0,
                           f"{pre}{name}.x", [f"{pre}{name}.offsets"]))
        task.center_adapt.register_forward_hook(keep(pre + "center", lambda a, o: o.detach()))
    return probes


def step_with_grads(model, batch, device, cfg, n_steps_total, perturb=0.0, perturb_seed=1,
                    mesh=None, spatial: bool = False):
    """One train step of a copy of ``model`` on ``device``: (loss, gradients, state
    after the AdamW update, lr of the step, library error), on the CPU in float64.
    ``perturb`` != 0 first scales every parameter by 1 + perturb * u, u uniform in
    [-1, 1] from ``perturb_seed`` (so -perturb moves each weight the other way).
    With a data-parallel ``mesh`` the step takes this rank's rows of ``batch``, its
    gradients are summed over the ranks before the update, and the loss and library
    errors are summed over them too. With ``spatial`` the copy's BEV stack is
    partitioned over ``mesh``'s spatial axis (``bev_sharding``).

    The library error of each of ``library_conv_probes``' convs (cuDNN or oneDNN, not a
    kernel of the port) is the largest distance of its f32 weight gradient from a
    float64 weight gradient of the same input and cotangent; under ``spatial``, of the
    gradient summed over the ranks from the whole map's input (gathered)."""
    from torch.nn.grad import conv2d_weight

    from tdal_torch.models.center_head import center_head_loss
    from tdal_torch.parallel.mesh import (
        all_reduce_grads, scope, shard_batch, spatial_sharding, sum_logs,
    )
    from tdal_torch.pipeline.detector_engine import TARGET_KEYS, batch_to_device
    from tdal_torch.runtime.schedules import adam_with_schedule, one_cycle

    m = copy.deepcopy(model).to(device).train()
    if spatial:
        m.bev_sharding = spatial_sharding(mesh)
    if perturb:
        gen = torch.Generator().manual_seed(perturb_seed)
        with torch.no_grad():
            for p in m.parameters():
                p.mul_(1 + perturb * (2 * torch.rand(p.shape, generator=gen) - 1).to(device))
    lr, mom = one_cycle(cfg.lr_config["lr_max"], n_steps_total)
    opt = adam_with_schedule(m.parameters(), lr, cfg.optimizer["wd"],
                             cfg.grad_clip["max_norm"], mom)
    b = batch_to_device(shard_batch(batch, mesh), device)
    head = cfg.model["bbox_head"]
    captured = {}
    probes = library_conv_probes(m, captured)
    if spatial:  # the head's row slab, to gather the probes' inputs
        m.head.register_forward_pre_hook(
            lambda mod, args, kwargs: captured.__setitem__("slab", kwargs["slab"]),
            with_kwargs=True)
    with scope(mesh):
        preds = m(b["points"])
        total, _ = center_head_loss(preds, {k: b[k] for k in TARGET_KEYS},
                                    head["code_weights"], head["weight"],
                                    has_vel=m.with_velocity)
        for t, p in enumerate(preds):
            captured.update({f"{t}/{n}": v for n, v in p.items()})
        keys = [k for *_, outs in probes for k in outs]
        couts = dict(zip(keys, torch.autograd.grad(total, [captured[k] for k in keys],
                                                   retain_graph=True)))
        total.backward()
        lib_f32 = {name: w.grad.detach().cpu().double()  # this rank's
                   for name, w, *_ in probes}
        if mesh is not None:
            all_reduce_grads(m.parameters(), mesh)
        if spatial:  # the summed gradient, against the whole map's
            lib_f32 = {name: w.grad.detach().cpu().double() for name, w, *_ in probes}
            for inp in dict.fromkeys(p[4] for p in probes):  # in one order on every rank
                captured[inp] = captured["slab"].gather(captured[inp])
        loss = float(sum_logs({"loss": total.detach()})["loss"])
    grads = {n: p.grad.detach().cpu().double() for n, p in m.named_parameters()}
    lib_err = {}
    for name, w, mask, pad, inp, outs in probes:
        g = torch.cat([couts[k] for k in outs], dim=-1).double()
        dw = conv2d_weight(captured[inp].double().permute(0, 3, 1, 2), w.shape,
                           g.permute(0, 3, 1, 2), padding=pad)
        if mask is not None:
            dw = dw * mask
        lib_err[name] = float((lib_f32[name] - dw.cpu()).abs().max())
    del captured, couts
    if mesh is not None:  # the ranks' errors on their rows bound that of their sum
        with mesh:
            lib_err = {k: float(v) for k, v in sum_logs(
                {k: torch.tensor(v, device=device) for k, v in lib_err.items()}).items()}
    opt.step()
    state = {k: v.detach().cpu().double() for k, v in m.state_dict().items()}
    return loss, grads, state, lr(0), lib_err


@contextlib.contextmanager
def without_second_moment_grad():
    """A wrong backward for a control: ``conv3x3_act_stats`` drops the cotangent of
    sum y^2, so the 2*y*gss term of its stats cotangent is gone."""
    from tdal_torch.ops import conv3x3 as cv

    fn = cv._ConvActStats
    original = fn.__dict__["backward"]
    keep_first = lambda g: g * g.new_tensor([[1.0], [0.0]])  # noqa: E731
    fn.backward = staticmethod(
        lambda ctx, gy, gstats: original.__func__(ctx, gy, keep_first(gstats)))
    try:
        yield
    finally:
        fn.backward = original


# The weight change is taken both ways, for two draws: a ReLU whose input sits within
# rounding of 0 (a whole empty BEV region shares one value per channel) flips on the side
# that rounds across it, and a signed change moves that input across 0 only half the
# time (``--noise-probe``; PERF.md has its readings)
PERTURBATIONS = [(sign, seed) for seed in (1, 2) for sign in (1, -1)]
NOISE_TERMS = ("permutation", *(f"{'+' if sign > 0 else '-'}2^-19 weights, draw {seed}"
                                 for sign, seed in PERTURBATIONS))
BATCH_PERMUTATIONS = {4: [2, 0, 3, 1], 2: [1, 0]}  # by batch size


def permuted(batch):
    """The batch's training inputs and targets reordered (``BATCH_PERMUTATIONS``)."""
    perm = BATCH_PERMUTATIONS[len(batch["points"])]
    return {k: ([a[perm] for a in v] if isinstance(v, list) else v[perm])
            for k, v in batch.items() if k in ("points", "hm", "anno_box", "ind", "mask",
                                               "cat")}


def first_frames(batch, n):
    """The training inputs and targets of the batch's first ``n`` frames."""
    return {k: ([a[:n] for a in v] if isinstance(v, list) else v[:n])
            for k, v in batch.items() if k in ("points", "hm", "anno_box", "ind", "mask",
                                               "cat")}


def noise_steps_of(model, batch, device, cfg, n_steps_total):
    """``step_with_grads`` of ``NOISE_TERMS``' steps of ``model`` on ``device``, in
    order."""
    return [step_with_grads(model, permuted(batch), device, cfg, n_steps_total),
            *(step_with_grads(model, batch, device, cfg, n_steps_total,
                              perturb=sign * ULP_PERTURBATION, perturb_seed=seed)
              for sign, seed in PERTURBATIONS)]


def noise_grads_of(model, batch, device, cfg, n_steps_total):
    """The gradients of ``NOISE_TERMS``' steps of ``model`` on ``device``, in order."""
    return [step[1] for step in noise_steps_of(model, batch, device, cfg, n_steps_total)]


def compare_steps(model, card, cpu, noise_grads, lr0, noise_states=None):
    """The card's train step (``card``: loss, gradients, state, library error) against
    the CPU's (``cpu``), with the noise floor from the CPU's gradients ``noise_grads``
    (one dict for each of ``NOISE_TERMS``). Returns (worst readings, failures, leaves);
    each reading but the loss's is an error over what is allowed, so above 1 fails.
    With ``noise_states`` (the CPU's states after the ``NOISE_TERMS``' steps) each BN
    running statistic is also held to ``GRAD_NOISE_MARGIN`` times its own noise floor
    (``stat_err_over_tol``), beside the 1e-4 relative bound."""
    loss_gpu, g_gpu, s_gpu, lib_gpu = card
    loss_cpu, g_cpu, s_cpu, lib_cpu = cpu
    worst = {"loss_rel_err": abs(loss_gpu - loss_cpu) / abs(loss_cpu),
             "grad_err_over_tol": 0.0, "param_err_over_allowed": 0.0, "stat_rel_err": 0.0,
             "stat_err_over_tol": 0.0, **{f"grad_err_over_tol_{t}": 0.0 for t in NOISE_TERMS}}
    failures, leaves = [], []
    if not worst["loss_rel_err"] <= 1e-4:
        failures.append(f"loss {loss_gpu} against {loss_cpu}")
    for k, want in g_cpu.items():
        got = g_gpu[k]
        # the noise floor, measured on the reference alone (so a card that rounds
        # worse cannot raise it): the change of the CPU's gradients under a
        # permutation of the batch (the loss and the BN statistics are invariant; it
        # reorders the cross-pixel sums) and under rounding-level changes of every
        # weight, each both ways (they move each pixel's dot products, which the two
        # sides round differently and no permutation reorders)
        terms = [float((want - g[k]).abs().max()) for g in noise_grads]
        noise = max(terms)
        # plus, for a library conv's weight (``library_conv_probes``), both
        # libraries' measured f32 error: a same-sign sum over B*H*W, whose rounding no
        # permutation shows
        base = 1e-4 * float(want.abs().max()) + 1e-6
        lib = lib_gpu.get(k, 0.0) + lib_cpu.get(k, 0.0)
        tol = max(base, GRAD_NOISE_MARGIN * noise) + lib
        err = float((got - want).abs().max())
        worst["grad_err_over_tol"] = max(worst["grad_err_over_tol"], err / tol)
        for name, term in zip(NOISE_TERMS, terms):  # each term as the only floor
            key = f"grad_err_over_tol_{name}"
            worst[key] = max(worst[key], err / (max(base, GRAD_NOISE_MARGIN * term) + lib))
        leaves.append((err / tol, k, err, float(want.abs().max()), noise))
        if err > tol:
            failures.append(f"grad {k}: {err:.3e} > {tol:.3e} (noise {noise:.3e})")
        # Adam's first step is about lr * sign(g): where g is within its tolerance of
        # zero either sign is right
        old = model.state_dict()[k].detach().cpu().double()
        allowed = 1e-5 * (1 + old.abs()) + (want.abs() <= tol) * 2.0 * lr0
        ratio = float(((s_gpu[k] - s_cpu[k]).abs() / allowed).max())
        worst["param_err_over_allowed"] = max(worst["param_err_over_allowed"], ratio)
        if ratio > 1:
            failures.append(f"param {k} after the update: {ratio:.2f} x allowed")
    for k in s_cpu:
        if "running" in k:
            rel = float((s_gpu[k] - s_cpu[k]).abs().max() / s_cpu[k].abs().max().clamp_min(1e-6))
            worst["stat_rel_err"] = max(worst["stat_rel_err"], rel)
            if rel > 1e-4:
                failures.append(f"BN statistic {k}: rel err {rel:.3e}")
            if noise_states is not None:
                err = float((s_gpu[k] - s_cpu[k]).abs().max())
                noise = max(float((s_cpu[k] - n[k]).abs().max()) for n in noise_states)
                # at least 4 f32 rounding steps of the statistic: a running average
                # that moves by less than one step shows no noise on the CPU
                tol = max(2.0**-21 * float(s_cpu[k].abs().max()), GRAD_NOISE_MARGIN * noise)
                worst["stat_err_over_tol"] = max(worst["stat_err_over_tol"], err / tol)
                if err > tol:
                    failures.append(f"BN statistic {k}: {err:.3e} > {tol:.3e} (noise "
                                    f"{noise:.3e})")
    return worst, failures, leaves


def check_step_against_cpu(model, model_bf16, batch, device, cfg, n_steps_total):
    """Phase 6's check: the same train step on the card and on a CPU copy (plain
    versions), and two controls that the same comparison must find wrong in the
    gradients: the card's step with ``without_second_moment_grad`` and the step of
    ``model_bf16`` (the same weights, bf16 activations) on the card."""
    return check_step_with_controls(
        model, batch, device, cfg, n_steps_total,
        {"no 2*y*gss": (model, without_second_moment_grad, "grad_err_over_tol"),
         "bf16 model": (model_bf16, contextlib.nullcontext, "grad_err_over_tol")},
        name="phase 6's card-vs-CPU step", deterministic_reference=True)


def cpu_reference(job: dict) -> dict:
    """A card-vs-CPU check's reference on the CPU: ``job``'s train step of its model on
    a CPU copy (plain versions), and its ``NOISE_TERMS``' steps, under ``deterministic``
    where the job says so. Returns the step (loss, gradients, state, library error),
    the noise steps' gradients (and states), and the seconds."""
    from tdal_torch.runtime.config import Config

    cpu, cfg = torch.device("cpu"), Config(job["cfg"])
    args = (job["model"], job["batch"], cpu, cfg, job["n_steps_total"])
    t0 = time.perf_counter()
    with deterministic() if job["deterministic"] else contextlib.nullcontext():
        loss, grads, state, _, lib = step_with_grads(*args)
        noise = noise_steps_of(*args)
    return dict(reference=(loss, grads, state, lib), noise_grads=[n[1] for n in noise],
                noise_states=[n[2] for n in noise] if job["stat_noise"] else None,
                seconds=time.perf_counter() - t0)


def lane_reference(job: bytes) -> bytes:
    """``cpu_reference`` in the CPU lane: the job and its result travel as ``torch.save``
    bytes, which hold no shared-memory handle of either process."""
    out = io.BytesIO()
    torch.save(cpu_reference(torch.load(io.BytesIO(job), weights_only=False)), out)
    return out.getvalue()


def cpu_lane():
    """The CPU lane: one child process that computes the card-vs-CPU checks' CPU
    references (``lane_reference``) one after another while this process goes on with
    the card's phases (they are about two thirds of the script's time and need no
    card). The readings of host work taken meanwhile share the cores with it (PERF.md
    has them with and without the lane)."""
    return concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))


LANE = None  # the cpu_lane() of a whole run; None runs each reference in this process


class PendingCheck:
    """A card-vs-CPU check whose card steps have run and whose CPU reference is coming
    (from ``LANE``, or computed here at once without one): ``result()`` judges it."""

    def __init__(self, name, judge, job):
        self.name, self.judge = name, judge
        if LANE is None:
            self.ref, self.future = cpu_reference(job), None
        else:
            blob = io.BytesIO()
            torch.save(job, blob)
            self.ref, self.future = None, LANE.submit(lane_reference, blob.getvalue())

    def result(self) -> dict:
        if self.ref is None:
            self.ref = torch.load(io.BytesIO(self.future.result()), weights_only=False)
        log(f"  {self.name}:")
        return self.judge(self.ref)


def check_step_with_controls(model, batch, device, cfg, n_steps_total, controls,
                             stat_noise: bool = False, name: str = "the check",
                             deterministic_reference: bool = False) -> PendingCheck:
    """The same train step of ``model`` on the card and on a CPU copy (plain versions),
    held by ``compare_steps``, and ``controls``: name -> (model, context manager to run
    its card step in, the reading that must exceed 1, or None for a control whose
    readings are printed only). The card's steps run now; the CPU copy's (the step and
    its noise-floor steps, under ``deterministic`` with ``deterministic_reference``) in
    ``LANE``: the returned check's ``result()`` waits for them and judges."""
    def card_step(m):
        loss, g, state, lr0, lib = step_with_grads(m, batch, device, cfg, n_steps_total)
        return (loss, g, state, lib), lr0

    t0 = time.perf_counter()
    card, lr0 = card_step(model)
    t_gpu = time.perf_counter() - t0
    control_steps = {}
    for cname, (m, context, _) in controls.items():
        with context():
            control_steps[cname] = card_step(m)[0]
    job = dict(model=copy.deepcopy(model).cpu(), batch=batch, cfg=cfg.to_dict(),
               n_steps_total=n_steps_total, stat_noise=stat_noise,
               deterministic=deterministic_reference)

    def judge(ref):  # on the weights of the step, whatever ``model`` holds by then
        return judge_steps(job["model"], batch, card, control_steps, controls, lr0, t_gpu,
                           ref, stat_noise)

    return PendingCheck(name, judge, job)


def judge_steps(model, batch, card, control_steps, controls, lr0, t_gpu, ref,
                stat_noise) -> dict:
    """``check_step_with_controls``' verdict on the card's steps and the CPU's
    reference ``ref`` (``cpu_reference``)."""
    reference, noise_grads, noise_states = ref["reference"], ref["noise_grads"], \
        ref["noise_states"]
    loss_cpu, t_cpu, lib_cpu = reference[0], ref["seconds"], reference[3]
    worst, failures, leaves = compare_steps(model, card, reference, noise_grads, lr0,
                                            noise_states)
    lib_gpu = card[3]
    log(f"  one step on the card against a CPU copy (batch {len(batch['points'])}): loss "
        f"{card[0]:.6f} / {loss_cpu:.6f}; "
        f"worst gradient error {worst['grad_err_over_tol']:.3f} of its tolerance "
        f"({GRAD_NOISE_MARGIN}x the noise floor or 1e-4 of the leaf's largest gradient); "
        f"worst parameter error {worst['param_err_over_allowed']:.3f} of allowed; BN "
        f"statistics rel err {worst['stat_rel_err']:.2e} (tol 1e-4); one step on the "
        f"card {t_gpu:.1f} s, {1 + len(NOISE_TERMS)} on the CPU {t_cpu:.1f} s (in the CPU "
        f"lane)")
    for ratio, k, err, scale, nz in sorted(leaves, reverse=True)[:3]:
        log(f"    gradient {k}: error {err:.3e} = {ratio:.3f} of tolerance; largest "
            f"gradient {scale:.3e}, noise floor {nz:.3e}")
    for k in lib_gpu:
        log(f"    {k}: f32 library weight gradient against float64, card "
            f"{lib_gpu[k]:.3e}, CPU {lib_cpu[k]:.3e}")
    readings = {"sound": worst}
    for name, (_, _, key) in controls.items():
        readings[name], c_fail, c_leaves = compare_steps(
            model, control_steps[name], reference, noise_grads, lr0, noise_states)
        top = sorted(c_leaves, reverse=True)[0]
        log(f"  control {name}: {len(c_fail)} failures ({c_fail[:2]}); worst gradient "
            f"{top[1]} at {top[0]:.3f} of its tolerance (error {top[2]:.3e}, noise floor "
            f"{top[4]:.3e}); " + (f"it must fail on {key}" if key else "printed only"))
        if key and not readings[name][key] > 1:
            failures.append(f"control {name}: its {key} passes the comparison")
    keys = ["loss_rel_err", "grad_err_over_tol",
            *(f"grad_err_over_tol_{t}" for t in NOISE_TERMS), "param_err_over_allowed",
            "stat_rel_err", *(["stat_err_over_tol"] if stat_noise else [])]
    log("    reading                                      " + "".join(
        f"{n:>14}" for n in readings))
    for k in keys:
        log(f"    {k:<45}" + "".join(f"{r[k]:>14.4g}" for r in readings.values()))
    if failures:
        raise AssertionError("the card's train step differs from the CPU's: "
                             + "; ".join(failures[:10]))
    return dict(loss_gpu=card[0], loss_cpu=loss_cpu, cpu_steps_s=t_cpu,
                controls={k: v for k, v in readings.items() if k != "sound"}, **worst)


def pp_training(root: Path):
    """The Waymo PP config's detector (fresh init from seed 0) on the card, its train
    state (OneCycle'd AdamW) and a synthetic training set written under ``root``:
    (cfg, model, state, dataset, total steps of the schedule)."""
    from tdal_torch.data.detection import DetectionDataset
    from tdal_torch.data.synthetic import make_synthetic_dataset
    from tdal_torch.models.builder import build_assigner, build_detector, build_voxel_config
    from tdal_torch.runtime.config import Config
    from tdal_torch.runtime.schedules import adam_with_schedule, one_cycle
    from tdal_torch.runtime.train_state import TrainState, param_count

    cfg = Config.fromfile(PP_CONFIG)
    voxel_cfg = build_voxel_config(cfg.voxel_generator, train=True)
    model = build_detector(cfg.model, voxel_cfg, seed=0)
    assigner = build_assigner(cfg.assigner, model)
    pre = cfg.train_preprocessor
    total_steps = PP_DATA["n_frames"] // PP_BATCH * cfg.total_epochs
    lr, mom = one_cycle(cfg.lr_config["lr_max"], total_steps, tuple(cfg.lr_config["moms"]),
                        cfg.lr_config["div_factor"], cfg.lr_config["pct_start"])
    opt = adam_with_schedule(model.parameters(), lr, cfg.optimizer["wd"],
                             cfg.grad_clip["max_norm"], mom)
    log(f"  {PP_CONFIG}: {param_count(model)} parameters, grid "
        f"{tuple(int(g) for g in voxel_cfg.grid_size)}, batch {PP_BATCH}, f32")
    t0 = time.perf_counter()
    infos, _ = make_synthetic_dataset(root / "data", **PP_DATA)
    ds = DetectionDataset(
        infos, cfg.class_names, assigner, voxel_cfg, mode="train",
        max_points=cfg.data["train"]["max_points"],
        global_rot_noise=tuple(pre["global_rot_noise"]),
        global_scale_noise=tuple(pre["global_scale_noise"]),
        shuffle_points=pre["shuffle_points"], seed=0)
    log(f"  {len(ds)} synthetic frames written in {time.perf_counter() - t0:.1f} s")
    return cfg, model, TrainState(model, opt), ds, total_steps


def train_epochs(state, ds, cfg, work: Path, epochs: int):
    """``epochs`` epochs of ``train_detector`` at ``PP_BATCH`` logging every step into
    ``work``, synchronised: (seconds, the metric rows)."""
    from tdal_torch.pipeline.detector_run import train_detector

    head = cfg.model["bbox_head"]
    t0 = time.perf_counter()
    train_detector(state, ds, head["code_weights"], n_epoch=epochs, batch_size=PP_BATCH,
                   logger=logging.getLogger("chip_smoke"), work_dir=work,
                   weight=head["weight"], log_every=1)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    return elapsed, [json.loads(line) for line in
                     (work / "logs" / "metrics.jsonl").read_text().splitlines()]


def pp_snapshot(root: Path):
    """Phase 6's snapshot: the Waymo PP detector of ``pp_training`` after
    ``PP_SNAPSHOT_EPOCHS`` under ``deterministic``, whose end is the same in every run.
    Returns (cfg, model, state, dataset, total steps, seconds, metric rows, the ops
    without a deterministic version)."""
    cfg, model, state, ds, total_steps = pp_training(root)
    with deterministic() as named:
        snap_s, rows = train_epochs(state, ds, cfg, root / "snapshot", PP_SNAPSHOT_EPOCHS)
    log(f"  snapshot epoch under deterministic algorithms in {snap_s:.1f} s; ops "
        f"without a deterministic version: {named or 'none'}")
    return cfg, model, state, ds, total_steps, snap_s, rows, named


CONV_KERNEL_NAMES = ("conv3x3_kernel", "wgrad_kernel", "stats_reduce_kernel",
                     "wgrad_reduce_kernel")


def union_ms(spans) -> float:
    """ms covered by the union of the (start, end) device intervals, in microseconds."""
    busy_us, reach = 0.0, -math.inf
    for a, b in sorted(spans):
        busy_us += max(0.0, b - max(a, reach))
        reach = max(reach, b)
    return busy_us / 1e3


def profile_step(step, state, batch) -> dict:
    """One train step under ``torch.profiler`` (CPU and CUDA activities): device time by
    kernel name, the conv kernels' summed share and the device's idle share of the
    step's synchronised wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name, spans = {}, []
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        r = evt.time_range
        by_name[evt.name] = by_name.get(evt.name, 0.0) + (r.end - r.start) / 1e3
        spans.append((r.start, r.end))
    if not spans:
        log("  torch.profiler showed no device time on this machine: the derived conv "
            "share below stands alone")
        return dict(device_events=0, wall_ms=wall_ms)
    busy_ms = union_ms(spans)
    conv_ms = sum(v for k, v in by_name.items() if any(n in k for n in CONV_KERNEL_NAMES))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    out = dict(device_events=len(spans), wall_ms=wall_ms, device_busy_ms=busy_ms,
               device_idle_share=1 - busy_ms / wall_ms, conv_kernels_ms=conv_ms,
               conv_share_of_step=conv_ms / wall_ms, conv_share_of_busy=conv_ms / busy_ms,
               top=[(k[:120], v) for k, v in top])
    log(f"  profiled step: {wall_ms:.1f} ms wall (profiler on), device busy {busy_ms:.1f} ms, "
        f"idle share {out['device_idle_share']:.3f}; the conv kernels {conv_ms:.1f} ms = "
        f"{100 * out['conv_share_of_step']:.1f}% of the step ({100 * out['conv_share_of_busy']:.1f}"
        f"% of the busy time); device time by kernel, top 10:")
    for k, v in top:
        log(f"    {v:9.3f} ms  {k[:120]}")
    return out


def phase_train(device) -> dict:
    from tdal_torch.data.detection import collate_detection
    from tdal_torch.models.builder import build_detector, build_voxel_config
    from tdal_torch.ops import conv3x3 as cv

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        # the check's weights and batch, reached through deterministic algorithms only:
        # the check's verdict is then a function of the code, not of the run
        cfg, model, state, ds, total_steps, _, snap_rows, _ = pp_snapshot(root)
        head = cfg.model["bbox_head"]
        snapshot = copy.deepcopy(model).cpu()
        batch = collate_detection([ds[i] for i in range(PP_BATCH)])

        def run(tag, epochs):
            return train_epochs(state, ds, cfg, root / tag, epochs)

        warm_s, warm_rows = run("warm", PP_WARM_EPOCHS)
        torch.cuda.reset_peak_memory_stats()
        for k in cv.launches:
            cv.launches[k] = 0
        timed_s, rows = run("timed", PP_TIMED_EPOCHS)
        launches = dict(cv.launches)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        losses = [r["loss"] for r in snap_rows + warm_rows + rows]
        log(f"  losses {losses}")
        log(f"  kernel launches in the {PP_TIMED} timed steps: {launches}")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"a non-finite loss: {losses}")
        if len(rows) != PP_TIMED:
            raise AssertionError(f"{len(rows)} timed steps logged, expected {PP_TIMED}")
        log(f"  launches per step: { {k: v / PP_TIMED for k, v in launches.items()} }")
        for name, n in launches.items():
            if n != PP_TIMED * PP_LAUNCHES[name]:
                raise AssertionError(f"{name}: {n} launches in {PP_TIMED} steps, expected "
                                     f"{PP_LAUNCHES[name]} per step")

        # the step alone on one batch, synchronised (host data excluded)
        from tdal_torch.pipeline.detector_engine import make_detector_steps

        step = make_detector_steps(model, head["code_weights"], head["weight"])

        step_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        step_ms = 1e3 * statistics.median(step_s)
        profiled = profile_step(step, state, batch)
        # the checkpoint that train_detector writes at each epoch's end, alone
        t0 = time.perf_counter()
        state.save(root / "checkpoint_probe.pt")
        ckpt_s = time.perf_counter() - t0
        frames_per_s = PP_TIMED * PP_BATCH / timed_s
        frames_per_s_no_ckpt = PP_TIMED * PP_BATCH / (timed_s - PP_TIMED_EPOCHS * ckpt_s)
        log(f"  train_detector: {PP_TIMED_EPOCHS} epochs of {PP_TIMED // PP_TIMED_EPOCHS} "
            f"steps in {timed_s:.3f} s (data, logging, a cold prefetch start and a "
            f"checkpoint at each epoch included), {frames_per_s:.2f} training frames/s; "
            f"one checkpoint alone {ckpt_s:.3f} s, so {frames_per_s_no_ckpt:.2f} frames/s "
            f"without them (derived); step alone {step_ms:.1f} ms (median of 3: "
            f"{', '.join(f'{1e3 * v:.1f}' for v in step_s)}); peak memory "
            f"{peak_gib:.2f} GiB; warm-up {warm_s:.1f} s")
        voxel_cfg = build_voxel_config(cfg.voxel_generator, train=True)
        model_bf16 = build_detector(dict(cfg.model, dtype="bfloat16"), voxel_cfg, "cpu", 0)
        model_bf16.load_state_dict(snapshot.state_dict())
        with deterministic() as named:
            check = check_step_against_cpu(snapshot, model_bf16,
                                           first_frames(batch, PP_CHECK_BATCH), device, cfg,
                                           total_steps)
        log(f"  the check's card steps ran under deterministic algorithms; ops without a "
            f"deterministic version: {named or 'none'}; its CPU copy runs in the CPU lane")
        del model_bf16
    return dict(launches=launches, losses=losses, step_ms=step_ms, step_s=step_s,
                profiled_step=profiled,
                timed_s=timed_s, frames_per_s=frames_per_s, checkpoint_s=ckpt_s,
                frames_per_s_without_checkpoints=frames_per_s_no_ckpt, peak_gib=peak_gib,
                check=check), cfg, model, snapshot.state_dict()


# ---------------------------------------------------------------------------
# phase 7: PointPillars inference on the Waymo config
# ---------------------------------------------------------------------------

PP_TEST_DATA = dict(n_scenes=1, n_frames=24, seed=1, n_static=10, n_dynamic=10,
                    points_per_object=256, n_background=150000)
INFER_BATCH = 4
# card against CPU, decoded maps: |card - cpu| <= MAP_TOL * max(1, |cpu|) elementwise,
# the heading's angle difference times the length r of its (rot0, rot1) vector against
# MAP_TOL * max(1, r) (atan2 divides the vector's error by r, which is near 0 at some
# pixels): f32 convolutions summed in another order through 20 layers
MAP_TOL = 1e-4
# a candidate kept on one side only must sit on a knife edge: its score within
# SCORE_EPS (= MAP_TOL, the largest score difference the map check lets through) of the
# score threshold, of the pre-NMS cut or of the post-NMS cut (the last kept box's score
# where a side filled all post-max slots: tied scores, as a whole empty BEV region
# gives, take the last slot in either order), an IoU within IOU_EPS of the NMS threshold
# against a box kept on either side, a score within SCORE_EPS of such an overlapping
# box's (their order may swap), or an overlap above the threshold less IOU_EPS with
# another candidate that differs for one of these reasons (a cascade)
SCORE_EPS = MAP_TOL
IOU_EPS = 1e-3


class _Records(logging.Handler):
    """Keeps the log records whose message starts with ``prefix``."""

    def __init__(self, prefix: str):
        super().__init__()
        self.prefix, self.records = prefix, []

    def emit(self, record):
        if isinstance(record.msg, str) and record.msg.startswith(self.prefix):
            self.records.append(record)


def kept_candidates(boxes, hm, test_cfg):
    """``post_process_task`` on one frame's decoded candidates: (indices of the kept
    candidates into the frame's HW, the candidates' scores, the NMS boxes)."""
    from tdal_torch.models.center_head import post_process_task

    r = post_process_task(boxes[None], hm[None], test_cfg)
    nms_boxes = boxes[:, [0, 1, 2, 3, 4, 5, boxes.shape[-1] - 1]]
    return r["index"][0][r["valid"][0]], hm.amax(dim=-1), nms_boxes


def explain_kept_difference(card_kept, cpu_kept, scores, nms_boxes, test_cfg):
    """The candidates kept on one side only, by knife edge (see ``SCORE_EPS``), judged
    on the CPU side's ``scores`` and ``nms_boxes``: ({reason: count}, [unexplained])."""
    from tdal_torch.core.iou import boxes_iou_bev

    a, b = set(card_kept.tolist()), set(cpu_kept.tolist())
    diff = sorted(a ^ b)
    if not diff:
        return {}, []
    thr = float(test_cfg["nms"]["nms_iou_threshold"])
    edges = [float(test_cfg["score_threshold"])]
    pre_max = int(test_cfg["nms"]["nms_pre_max_size"])
    if len(scores) > pre_max:
        edges.append(float(torch.sort(scores, descending=True).values[pre_max - 1]))
    # the post-NMS cut: a side's last kept score, where it filled all its slots
    post_max = int(test_cfg["nms"]["nms_post_max_size"])
    last = {side: float(scores[k].min()) if len(k) == post_max else None
            for side, k in (("card", card_kept), ("cpu", cpu_kept))}
    kept = sorted(a | b)
    iou = boxes_iou_bev(nms_boxes[diff], nms_boxes[kept]).cpu()  # (diff, kept)
    s = scores.cpu()
    reasons = {}
    for i, c in enumerate(diff):
        others = torch.tensor([k != c for k in kept])
        near = (iou[i] - thr).abs() <= IOU_EPS
        swap = (iou[i] > thr - IOU_EPS) & ((s[kept] - s[c]).abs() <= SCORE_EPS)
        other_cut = last["cpu" if c in a else "card"]  # the slot it took or lost
        if any(abs(float(s[c]) - e) <= SCORE_EPS for e in edges):
            reasons[c] = "score"
        elif other_cut is not None and abs(float(s[c]) - other_cut) <= SCORE_EPS:
            reasons[c] = "post-cut"
        elif (near & others).any():
            reasons[c] = "iou"
        elif (swap & others).any():
            reasons[c] = "order"
    changed = True
    while changed:  # a knife-edge candidate kept on one side suppresses others there
        changed = False
        for i, c in enumerate(diff):
            if c in reasons:
                continue
            if any(k in reasons and iou[i, j] > thr - IOU_EPS for j, k in enumerate(kept)):
                reasons[c], changed = "cascade", True
    counts = {}
    for r in reasons.values():
        counts[r] = counts.get(r, 0) + 1
    return counts, [c for c in diff if c not in reasons]


def knife_edge_detail(c, card_kept, cpu_kept, card_scores, scores, nms_boxes) -> str:
    """What an unexplained candidate, kept on one side only, looks like: its score on
    both sides, each side's last kept score (on the CPU's scores), and its largest BEV
    IoU with another box kept on either side."""
    from tdal_torch.core.iou import boxes_iou_bev

    on_card = c in set(card_kept.tolist())
    kept = sorted((set(card_kept.tolist()) | set(cpu_kept.tolist())) - {c})
    iou = boxes_iou_bev(nms_boxes[[c]], nms_boxes[kept]).cpu()[0]
    j = int(iou.argmax())
    return (f"candidate {c} kept on the {'card' if on_card else 'CPU'} only: score card "
            f"{float(card_scores[c]):.7f}, CPU {float(scores[c]):.7f}; last kept score card "
            f"{float(scores[card_kept].min()):.7f} ({len(card_kept)} kept), CPU "
            f"{float(scores[cpu_kept].min()):.7f} ({len(cpu_kept)}); largest IoU "
            f"{float(iou[j]):.5f} with {kept[j]} (score {float(scores[kept[j]]):.7f})")


def check_infer_against_cpu(model, points, test_cfg) -> dict:
    """One batch through ``model`` on the card and through a CPU copy (plain layers):
    the decoded maps within ``MAP_TOL``, and per frame the kept sets equal but for
    knife-edge candidates, which are counted."""
    cpu_model = copy.deepcopy(model).cpu().eval()
    model.eval()
    with torch.no_grad():
        t0 = time.perf_counter()
        maps_cpu = cpu_model(points.cpu())
        cpu_s = time.perf_counter() - t0
        maps_card = model(points)
    out = compare_maps(maps_card, maps_cpu, test_cfg)
    out["cpu_forward_s"] = cpu_s
    log(f"  one batch on the card against a CPU copy: decoded maps' errors (tol {MAP_TOL:.0e}) "
        + ", ".join(f"{k} {v:.3e}" for k, v in out["map_rel_err"].items())
        + f"; {out['kept_ref']} boxes kept on the CPU, {out['differing']} kept on one side "
        f"only: knife edges {out['knife_edge']}, unexplained {out['unexplained']}; CPU "
        f"forward {cpu_s:.1f} s")
    failures = [k for k, v in out["map_rel_err"].items()
                if not v <= MAP_TOL and k != "heading (rad)"]
    if failures or out["unexplained"]:
        raise AssertionError(f"inference on the card differs from the CPU's: maps {failures}, "
                             f"kept sets {out['unexplained_at'][:10]}")
    out["kept_cpu"] = out.pop("kept_ref")
    del out["unexplained_at"]
    return out


def compare_maps(maps, maps_ref, test_cfg) -> dict:
    """Two forwards' head maps (each decoded where it lies), held as phase 7 holds the
    card against the CPU: the decoded maps' relative errors (``map_rel_err``, each against
    ``MAP_TOL``), and per frame the kept sets, equal but for knife-edge candidates
    (judged on ``maps_ref``'s side): the boxes kept on the reference side, those kept on
    one side only, their knife-edge reasons and the unexplained ones."""
    from tdal_torch.models.center_head import decode_preds

    with torch.no_grad():
        decoded = [(decode_preds(mc, test_cfg), decode_preds(mp, test_cfg))
                   for mc, mp in zip(maps, maps_ref)]
    maps_cpu = [{k: v.cpu() for k, v in m.items()} for m in maps_ref]
    worst = {}
    counts, unexplained, n_diff, n_kept = {}, [], 0, 0
    for task, ((bc, hc), (bp, hp)) in enumerate(decoded):
        bc, hc, bp, hp = bc.cpu(), hc.cpu(), bp.cpu(), hp.cpu()
        errs = {"hm": (hc - hp).abs() / hp.abs().clamp_min(1)}
        cols = ["x", "y", "z", "l", "w", "h", "vx", "vy"][: bc.shape[-1] - 1]
        for i, name in enumerate(cols):
            errs[name] = (bc[..., i] - bp[..., i]).abs() / bp[..., i].abs().clamp_min(1)
        r = maps_cpu[task]["rot"].reshape(bp.shape[0], -1, 2).norm(dim=-1)
        angle = torch.remainder(bc[..., -1] - bp[..., -1] + math.pi, 2 * math.pi) - math.pi
        errs["heading x r"] = angle.abs() * r / r.clamp_min(1)
        for name, e in errs.items():
            worst[name] = max(worst.get(name, 0.0), float(e.max()))
        worst["heading (rad)"] = max(worst.get("heading (rad)", 0.0), float(angle.abs().max()))
        for f in range(bc.shape[0]):
            kc, sc, _ = kept_candidates(bc[f], hc[f], test_cfg)
            kp, sp, boxes_p = kept_candidates(bp[f], hp[f], test_cfg)
            c, u = explain_kept_difference(kc, kp, sp, boxes_p, test_cfg)
            n_kept += len(kp)
            n_diff += len(set(kc.tolist()) ^ set(kp.tolist()))
            for k, v in c.items():
                counts[k] = counts.get(k, 0) + v
            unexplained += [(task, f, int(i), knife_edge_detail(int(i), kc, kp, sc, sp, boxes_p))
                            for i in u]
    return dict(map_rel_err=worst, kept_ref=n_kept, differing=n_diff, knife_edge=counts,
                unexplained=len(unexplained), unexplained_at=unexplained)


def phase_infer(device, cfg, trained) -> tuple:
    """``run_inference`` (plain and double-flip) and ``evaluate_detector`` at the Waymo PP
    config's test settings with phase 6's weights, on a synthetic test split. Returns
    the readings and the points of the batch held against the CPU (phase 14's)."""
    from tdal_torch.data.detection import DetectionDataset
    from tdal_torch.data.synthetic import make_synthetic_dataset
    from tdal_torch.models.builder import (
        build_assigner, build_detector, build_test_cfg, build_voxel_config,
    )
    from tdal_torch.models.center_head import predict
    from tdal_torch.ops import conv3x3 as cv
    from tdal_torch.pipeline.detector_run import evaluate_detector, run_inference
    from tdal_torch.runtime.train_state import TrainState

    logger = logging.getLogger("chip_smoke")
    timing = _Records("Total time per frame")
    logger.addHandler(timing)
    voxel_cfg = build_voxel_config(cfg.voxel_generator, train=False)
    model = build_detector(cfg.model, voxel_cfg, device=device, seed=0)
    model.load_state_dict(trained.state_dict())
    test_cfg = build_test_cfg(cfg.test_cfg, model, voxel_cfg)
    state = TrainState(model, None)
    out = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            infos, _ = make_synthetic_dataset(Path(tmp) / "test", **PP_TEST_DATA)
            ds = DetectionDataset(infos, cfg.class_names, build_assigner(cfg.assigner, model),
                                  voxel_cfg, mode="test",
                                  max_points=cfg.data["val"]["max_points"])
            log(f"  {len(ds)} synthetic test frames written in {time.perf_counter() - t0:.1f} "
                f"s; max voxels {voxel_cfg.max_voxels}, NMS {test_cfg['nms']}, score "
                f"threshold {test_cfg['score_threshold']}")
            for k in cv.launches:
                cv.launches[k] = 0
            for double_flip in (False, True):
                tag = "double-flip" if double_flip else "plain"
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                dets = run_inference(state, ds, test_cfg, INFER_BATCH, logger,
                                     speed_test=True, double_flip=double_flip)
                total = time.perf_counter() - t0
                s_per_frame = timing.records.pop().args[0]
                kept = [len(d["scores"]) for d in dets.values()]
                if len(dets) != len(ds) or not all(
                        np.isfinite(d["box3d_lidar"]).all() and d["box3d_lidar"].shape[1] == 7
                        for d in dets.values()):
                    raise AssertionError(f"{tag}: detections missing, not finite or not 7 wide")
                out[tag] = dict(frames_per_s=1.0 / s_per_frame, s_per_frame=s_per_frame,
                                total_s=total, kept_per_frame=float(np.mean(kept)),
                                kept_min=min(kept), kept_max=max(kept),
                                peak_gib=torch.cuda.max_memory_allocated() / 2**30)
                log(f"  run_inference {tag}: {out[tag]['frames_per_s']:.3f} frames/s (middle "
                    f"third, synchronised; {s_per_frame:.6f} s per frame); {len(ds)} frames in "
                    f"{total:.2f} s with the host data; kept boxes per frame "
                    f"{out[tag]['kept_per_frame']:.1f} ({min(kept)}-{max(kept)}); peak memory "
                    f"{out[tag]['peak_gib']:.2f} GiB")
            out["launches"] = dict(cv.launches)
            log(f"  conv kernel launches in inference: {out['launches']} (eval folds each BN "
                f"into a cuDNN conv, as tdal's eval runs XLA convs)")

            # one batch: the forward and the decode + NMS timed apart
            points = torch.as_tensor(np.stack([ds[i]["points"] for i in range(INFER_BATCH)]),
                                     device=device)
            fwd, post = [], []
            with torch.no_grad():
                for _ in range(4):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    maps = model(points)
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    predict(maps, test_cfg, model.num_classes)
                    torch.cuda.synchronize()
                    fwd.append(t1 - t0)
                    post.append(time.perf_counter() - t1)
            out["forward_ms_per_batch"] = 1e3 * statistics.median(fwd[1:])
            out["nms_ms_per_frame"] = 1e3 * statistics.median(post[1:]) / INFER_BATCH
            log(f"  one batch of {INFER_BATCH}: forward {out['forward_ms_per_batch']:.1f} ms, "
                f"decode + NMS {out['nms_ms_per_frame']:.1f} ms per frame (medians of 3)")
            out["cpu_check"] = check_infer_against_cpu(model, points, test_cfg)
            test_points = points.cpu()

            t0 = time.perf_counter()
            out["ap"] = evaluate_detector(state, ds, test_cfg, INFER_BATCH, logger)
            log(f"  evaluate_detector on the {len(ds)} frames ({time.perf_counter() - t0:.1f} "
                f"s): " + ", ".join(f"{k} {v:.4f}" for k, v in out["ap"].items()))
    finally:
        logger.removeHandler(timing)
    return out, test_points


# ---------------------------------------------------------------------------
# phase 8: the offboard chain (labeler training, then the detector-fed chain)
# ---------------------------------------------------------------------------

# (a) a GT-fed segment of 8 scenes: 160 static tracks (one sample each: 144 train, two
# batches of 64 with drop_last) and 16 dynamic ones (160 per-frame samples)
LABEL_SEGMENT = dict(n_scenes=8, n_frames=10, seed=3, n_static=20, n_dynamic=2,
                     points_per_object=256, n_background=5000)
LABEL_BATCH, LABEL_EPOCHS, LABEL_LR = 64, 3, 1e-3
CHECK_SETS = 8  # the card-vs-CPU step: sets of the check batch, at production widths
STAT_TOL = 1e-4  # BN running statistics, relative to the leaf's largest value
# a seg logit within this of 0, relative to max(1, max |logit|), is a knife edge: the
# card's and the CPU's f32 sums may put its point on either side
SEG_KNIFE_EDGE = 1e-4
# (b) the detector-fed chain: bus-sized objects as in tdal's real-detector test
CHAIN_SEGMENT = dict(n_scenes=1, n_frames=10, seed=7, n_static=6, n_dynamic=2,
                     points_per_object=384, n_background=20000, object_dims=(10.0, 2.6, 3.2))
CHAIN_WARM_SEGMENT = dict(CHAIN_SEGMENT, n_frames=8, seed=8)
CHAIN_ROUND_STEPS, CHAIN_MAX_STEPS = 45, 180  # detector steps per round, and the cap
CHAIN_SCORE_THRESHOLD = 0.02  # a briefly trained detector's scores are low
CHAIN_KW = dict(score_percentile=90, match_iou=0.25, npoints_static=NPOINTS_STATIC,
                npoints_dynamic=NPOINTS_DYNAMIC, predict_batch=PREDICT_BATCH)


def labeler_segment(root: Path, seg: dict):
    """A GT-fed segment through stages 2-4 on the card: (annos, static tracks,
    dynamic tracks), with the tracks matched to their GT."""
    from tdal_torch.data.synthetic import fabricate_detections, make_synthetic_dataset
    from tdal_torch.data.waymo_schema import AnnoStore, reorganize_info
    from tdal_torch.pipeline.motion_state import (
        build_track_gt, fit_motion_classifier, split_by_prediction, track_features,
    )
    from tdal_torch.pipeline.track_extraction import (
        convert_detection_to_global_box, create_pd_detection, reorganize, run_tracking,
    )

    infos, scenes = make_synthetic_dataset(root / "segment", **seg)
    info_map = reorganize_info(infos)
    annos = AnnoStore(info_map)
    detections = fabricate_detections(scenes, annos)
    global_preds, det_results = convert_detection_to_global_box(detections, info_map, annos)
    predictions, _ = run_tracking(global_preds, det_results, score_thresh=0.1)
    _, frame_track = create_pd_detection(predictions, info_map, root / "track", tracking=True)
    X, y, new_track = track_features(reorganize(frame_track), build_track_gt(infos))
    static, dynamic = split_by_prediction(new_track, fit_motion_classifier(X, y).predict(X))
    return annos, static, dynamic


def labeler_step(model, loss_fn, inputs, labels, draws, device, perturb=0.0, perturb_seed=1,
                 mesh=None):
    """One train step (AdamW on the labelers' schedule) of a copy of ``model`` on
    ``device``: (loss, gradients and the state after the update in float64 on the CPU,
    the seg mask, the seg logits). ``perturb`` != 0 first scales every parameter by
    1 + perturb * u, u uniform in [-1, 1] from ``perturb_seed``. With a data-parallel
    ``mesh`` the step takes this rank's rows (mask and logits are its rows), and its
    loss and gradients are summed over the ranks."""
    from tdal_torch.parallel.mesh import all_reduce_grads, rank_rows, scope, sum_logs
    from tdal_torch.runtime.schedules import adam_with_schedule, labeler_step_decay

    m = copy.deepcopy(model).to(device).train()
    if perturb:
        gen = torch.Generator().manual_seed(perturb_seed)
        with torch.no_grad():
            for p in m.parameters():
                p.mul_(1 + perturb * (2 * torch.rand(p.shape, generator=gen) - 1).to(device))
    opt = adam_with_schedule(m.parameters(), labeler_step_decay(LABEL_LR, 1), 1e-4)
    rows = lambda t: rank_rows(t, mesh).to(device)  # noqa: E731
    with scope(mesh):
        out = m(*(rows(x) for x in inputs), **{k: rows(v) for k, v in draws.items()})
        total = loss_fn(out, {k: rows(v) for k, v in labels.items()})["total_loss"]
        total.backward()
        if mesh is not None:
            all_reduce_grads(m.parameters(), mesh)
        loss = float(sum_logs({"loss": total.detach()})["loss"])
    grads = {n: p.grad.detach().cpu().double() for n, p in m.named_parameters()}
    opt.step()
    state = {k: v.detach().cpu().double() for k, v in m.state_dict().items()}
    return loss, grads, state, out["mask"].cpu(), out["logits"].detach().cpu()


class _TorchBatchNorm(torch.nn.BatchNorm1d):
    """torch's BatchNorm over the last axis, whose running variance is the unbiased
    one: the control of the labelers' card-vs-CPU step check."""

    def forward(self, x):
        return super().forward(x.reshape(-1, x.shape[-1])).reshape(x.shape)


def with_torch_batchnorm(model):
    """A copy of ``model`` whose (B, C) stacks run ``_TorchBatchNorm`` on its weights."""
    from tdal_torch.models.pointnet import DenseBNStack, SharedMLP

    m = copy.deepcopy(model)
    for mod in m.modules():
        if isinstance(mod, DenseBNStack) and not isinstance(mod, SharedMLP):
            for i, bn in enumerate(mod.bn):
                tbn = _TorchBatchNorm(bn.weight.numel(), eps=bn.eps, momentum=bn.momentum)
                tbn.load_state_dict(bn.state_dict(), strict=False)
                mod.bn[i] = tbn.to(bn.weight.device)
    return m


def _subset(inputs, labels, draws, keep):
    pick = lambda t: t[keep]  # noqa: E731
    return ([pick(x) for x in inputs], {k: pick(v) for k, v in labels.items()},
            {k: pick(v) for k, v in draws.items()})


def compare_labeler_steps(model, ref, c, noise):
    """A labeler step ``c`` (``labeler_step``'s loss, gradients and state) against the
    reference step ``ref``, with the noise floor of the reference's gradients in
    ``noise`` ((term, gradients) pairs): (worst readings, failures). The loss within
    1e-4 relative, the BN running statistics ``STAT_TOL``, the gradients within
    ``GRAD_NOISE_MARGIN`` times the floor or 1e-5 of the leaf's largest gradient, the
    parameters after the update 1e-5 (1 + |p|), plus Adam's sign either way."""
    loss_c, g_c, s_c = c[:3]
    worst = {"loss_rel_err": abs(loss_c - ref[0]) / abs(ref[0]),
             "grad_err_over_tol": 0.0, "param_err_over_allowed": 0.0,
             "stat_rel_err": 0.0}
    fails = []
    for k, want in ref[1].items():
        floor = max(float((want - g[k]).abs().max()) for _, g in noise)
        tol = max(1e-5 * float(want.abs().max()) + 1e-12, GRAD_NOISE_MARGIN * floor)
        err = float((g_c[k] - want).abs().max())
        worst["grad_err_over_tol"] = max(worst["grad_err_over_tol"], err / tol)
        if err > tol:
            fails.append(f"grad {k}: {err:.3e} > {tol:.3e} (floor {floor:.3e})")
        old = model.state_dict()[k].detach().cpu().double()
        allowed = 1e-5 * (1 + old.abs()) + (want.abs() <= tol) * 2.0 * LABEL_LR
        ratio = float(((s_c[k] - ref[2][k]).abs() / allowed).max())
        worst["param_err_over_allowed"] = max(worst["param_err_over_allowed"], ratio)
        if ratio > 1:
            fails.append(f"param {k}: {ratio:.2f} x allowed")
    for k, want in ref[2].items():
        if "running" in k:
            rel = float((s_c[k] - want).abs().max() / want.abs().max().clamp_min(1e-6))
            worst["stat_rel_err"] = max(worst["stat_rel_err"], rel)
            if rel > STAT_TOL:
                fails.append(f"BN statistic {k}: rel err {rel:.3e}")
    if worst["loss_rel_err"] > 1e-4:
        fails.append(f"loss {loss_c} against {ref[0]}")
    return worst, fails


def check_labeler_step_against_cpu(name, model, loss_fn, inputs, labels, device,
                                   seed: int = 0) -> dict:
    """One train step of ``model`` on ``device`` against the same step on a CPU copy:
    the same weights, batch (CPU tensors ``inputs`` and ``labels``), gather noise and
    dropout mask (drawn with numpy from ``seed``). Sets whose seg mask differs between
    the two sides must each differ only at points on a knife edge (CPU |logit margin|
    under ``SEG_KNIFE_EDGE``); they are counted and taken out of the batch. Then the
    loss (1e-4 relative), the BN running statistics (``STAT_TOL``), the gradients
    (within ``GRAD_NOISE_MARGIN`` times a noise floor measured on the CPU copy as phase
    6 measures its own, or 1e-5 of the leaf's largest gradient) and the parameters after
    the update must agree; and the same step with torch's unbiased running variance
    (``with_torch_batchnorm``) on the card must fail that comparison."""
    cpu = torch.device("cpu")
    b, n = inputs[0].shape[:2]
    rng = np.random.default_rng(seed)
    draws = {"noise": torch.from_numpy(rng.random((b, n), dtype=np.float32)),
             "keep": torch.from_numpy(rng.random((b, n, 128)) >= 0.5)}
    knife_sets = 0
    for _ in range(3):
        card = labeler_step(model, loss_fn, inputs, labels, draws, device)
        ref = labeler_step(model, loss_fn, inputs, labels, draws, cpu)
        differ = (card[3] != ref[3]).any(dim=1)
        if not differ.any():
            break
        lg = ref[4]
        margin = (lg[..., 1] - lg[..., 0]).abs()
        edge = SEG_KNIFE_EDGE * max(1.0, float(lg.abs().max()))
        for i in torch.nonzero(differ).flatten().tolist():
            worst = float(margin[i][card[3][i] != ref[3][i]].max())
            if not worst <= edge:
                raise AssertionError(f"{name}: set {i}'s seg mask differs on the card at a "
                                     f"logit margin of {worst:.3e} (knife edge {edge:.3e})")
        knife_sets += int(differ.sum())
        inputs, labels, draws = _subset(inputs, labels, draws, ~differ)
    else:
        raise AssertionError(f"{name}: the seg masks still differ after taking out "
                             f"{knife_sets} knife-edge sets")
    if len(inputs[0]) < CHECK_SETS // 2:
        raise AssertionError(f"{name}: {knife_sets} of {CHECK_SETS} sets on knife edges")
    perm = torch.arange(len(inputs[0])).roll(1)
    noise, dropped = [], []
    p_inputs, p_labels, p_draws = _subset(inputs, labels, draws, perm)
    terms = [("permutation", lambda: labeler_step(model, loss_fn, p_inputs, p_labels,
                                                  p_draws, cpu), perm)]
    for sign, s in PERTURBATIONS:
        terms.append((f"{'+' if sign > 0 else '-'}2^-19 weights, draw {s}",
                      lambda sign=sign, s=s: labeler_step(
                          model, loss_fn, inputs, labels, draws, cpu,
                          perturb=sign * ULP_PERTURBATION, perturb_seed=s), None))
    for term, step, order in terms:
        res = step()
        mask = res[3] if order is None else res[3][torch.argsort(order)]
        # a term that moved a point across the seg boundary measures that, not rounding
        (noise if torch.equal(mask, ref[3]) else dropped).append((term, res[1]))
    if not noise:
        raise AssertionError(f"{name}: every noise term moved a seg decision")

    sound, failures = compare_labeler_steps(model, ref, card, noise)
    control, control_fails = compare_labeler_steps(
        model, ref, labeler_step(with_torch_batchnorm(model), loss_fn, inputs, labels, draws,
                                 device), noise)
    log(f"  {name}: one train step of {len(inputs[0])} sets on the card against a CPU copy "
        f"({knife_sets} knife-edge sets taken out; noise terms {[t for t, _ in noise]}, "
        f"dropped {[t for t, _ in dropped]}): " + ", ".join(
            f"{k} {v:.3g}" for k, v in sound.items()))
    log(f"  {name}: control (torch's unbiased running variance): {len(control_fails)} "
        f"failures, " + ", ".join(f"{k} {v:.3g}" for k, v in control.items()))
    if not control_fails:
        failures.append("the control (unbiased running variance) passes the comparison")
    if failures:
        raise AssertionError(f"{name}: the card's train step differs from the CPU's: "
                             + "; ".join(failures[:10]))
    return dict(sound=sound, control=control, knife_edge_sets=knife_sets,
                sets=len(inputs[0]), noise_terms=[t for t, _ in noise],
                dropped_noise_terms=[t for t, _ in dropped])


def train_labeler_on_card(name, model_type, datasets, logger, root, device) -> dict:
    """``train_labeler`` at batch ``LABEL_BATCH`` for ``LABEL_EPOCHS`` epochs (per-epoch
    eval through K1/K2, the best checkpoint), the step alone, then
    ``restore_labeler_state``, ``predict_final_boxes`` and the postprocess metrics."""
    from tdal_torch.ops import fused_pointnet as fp
    from tdal_torch.pipeline.factories import make_labeler, restore_labeler_state
    from tdal_torch.pipeline.labeler_engine import make_steps
    from tdal_torch.pipeline.labeler_run import train_labeler
    from tdal_torch.data.track_datasets import batch_iterator
    from tdal_torch.runtime.schedules import adam_with_schedule, labeler_step_decay
    from tdal_torch.runtime.train_state import TrainState

    train_ds, val_ds, post = datasets
    model, loss_fn, inputs_fn, kind = make_labeler(model_type, seed=0)
    steps_per_epoch = len(train_ds) // LABEL_BATCH
    opt = adam_with_schedule(model.parameters(), labeler_step_decay(LABEL_LR, steps_per_epoch),
                             1e-4)
    state = TrainState(model, opt)
    for k in fp.launches:
        fp.launches[k] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, best = train_labeler(model, loss_fn, inputs_fn, state, train_ds, val_ds,
                                LABEL_EPOCHS, LABEL_BATCH, logger, ckpt_dir=root / name, seed=0)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(fp.launches)
    eval_batches = LABEL_EPOCHS * math.ceil(len(val_ds) / LABEL_BATCH)
    samples = LABEL_EPOCHS * steps_per_epoch * LABEL_BATCH
    peak = torch.cuda.max_memory_allocated() / 2**30
    for k, v in launches.items():
        if v != eval_batches:
            raise AssertionError(f"{name}: {k} launched {v} times in train_labeler, "
                                 f"{eval_batches} eval batches")
    if best.get("epoch") is None or state.step != LABEL_EPOCHS * steps_per_epoch:
        raise AssertionError(f"{name}: {state.step} steps, best {best}")

    # the step alone on one batch, synchronised (host data excluded)
    train_step, _ = make_steps(model, loss_fn, inputs_fn)
    batch = next(batch_iterator(train_ds, LABEL_BATCH, shuffle=True, seed=99, drop_last=True))
    gen = torch.Generator(device=device).manual_seed(1)
    step_s = []
    for _ in range(4):
        t1 = time.perf_counter()
        metrics = train_step(state, batch, gen)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
    if not all(math.isfinite(float(v)) for v in metrics.values()):
        raise AssertionError(f"{name}: a non-finite metric {metrics}")
    step_ms = 1e3 * statistics.median(step_s[1:])

    restored, meta = restore_labeler_state(make_labeler(model_type, seed=1)[0], root / name)
    if meta["epoch"] != best["epoch"]:
        raise AssertionError(f"{name}: restored {meta}, best {best}")
    post_ds, post_fn, tracks, annos = post
    boxes = predict_final_boxes_checked(restored, post_ds, inputs_fn, kind, device)
    metrics_post = post_fn(tracks, annos, boxes, logger)
    log(f"  {name}: {LABEL_EPOCHS} epochs of {steps_per_epoch} steps at batch {LABEL_BATCH} in "
        f"{train_s:.2f} s ({samples / train_s:.1f} samples/s, data, eval and checkpoints "
        f"included); step alone {step_ms:.1f} ms (median of 3: "
        f"{', '.join(f'{1e3 * v:.1f}' for v in step_s[1:])}); peak memory {peak:.2f} GiB; "
        f"K1/K2 launches in train_labeler {launches} for {eval_batches} eval batches; best "
        f"epoch {best['epoch']} (eval acc@0.7 {best['eval_iou3d_acc']:.3f}); restored and "
        f"labeled {len(boxes)} boxes, IoU 2D/3D/acc {metrics_post}")
    return dict(model=restored, loss_fn=loss_fn, inputs_fn=inputs_fn, kind=kind,
                reading=dict(train_s=train_s, samples_per_s=samples / train_s, step_ms=step_ms,
                             step_s=step_s[1:], peak_gib=peak, launches=launches,
                             eval_batches=eval_batches, best=best, post_metrics=metrics_post,
                             boxes=len(boxes), train_samples=len(train_ds),
                             val_samples=len(val_ds)))


def predict_final_boxes_checked(model, ds, inputs_fn, kind, device):
    from tdal_torch.pipeline.labeler_run import predict_final_boxes

    boxes = predict_final_boxes(model, ds, inputs_fn, kind, PREDICT_BATCH, device=device)
    if not (len(boxes) == len(ds) and np.isfinite(boxes).all()):
        raise AssertionError(f"predict_final_boxes: {boxes.shape}, finite "
                             f"{np.isfinite(boxes).all()}")
    return boxes


def check_batch(ds, inputs_fn, n):
    """The first ``n`` samples of ``ds``: (CPU input tensors, CPU label tensors)."""
    from tdal_torch.data.track_datasets import batch_iterator
    from tdal_torch.pipeline.labeler_engine import LABEL_KEYS

    batch = next(batch_iterator(ds, n, pad_to_full=True))
    return ([torch.as_tensor(np.asarray(x)) for x in inputs_fn(batch)],
            {k: torch.as_tensor(np.asarray(batch[k])) for k in LABEL_KEYS})


def phase_labelers(device, root: Path, logger) -> dict:
    """8(a): both labelers trained on the card at their production widths."""
    from tdal_torch.data.track_datasets import (
        DynamicTrackDataset, StaticTrackDataset, preprocess_tracks,
    )
    from tdal_torch.pipeline.labeler_run import postprocess_dynamic, postprocess_static

    t0 = time.perf_counter()
    annos, static, dynamic = labeler_segment(root, LABEL_SEGMENT)
    s_train, s_val = preprocess_tracks(static, annos, ratio=0.1, seed=0)
    d_train, d_val = preprocess_tracks(dynamic, annos, ratio=0.1, seed=0)
    log(f"  labeler segment ({LABEL_SEGMENT['n_scenes']} scenes) through stages 2-4 in "
        f"{time.perf_counter() - t0:.1f} s: {len(static)} static tracks ({len(s_train)} train,"
        f" {len(s_val)} eval), {len(dynamic)} dynamic ({len(d_train)} train, {len(d_val)} "
        f"eval)")
    out = {}
    for name, model_type, cls, npts, (tr, va), post in (
        ("static", "one_box_est", StaticTrackDataset, NPOINTS_STATIC, (s_train, s_val),
         postprocess_static),
        ("dynamic", "dynamic", DynamicTrackDataset, NPOINTS_DYNAMIC, (d_train, d_val),
         postprocess_dynamic),
    ):
        make = lambda t, s, cls=cls, npts=npts: cls(t, annos, npoints=npts, seed=s)  # noqa: E731
        train_ds, val_ds = make(tr, 0), make(va, 1)
        if len(train_ds) < 2 * LABEL_BATCH:
            raise AssertionError(f"{name}: {len(train_ds)} train samples, fewer than two "
                                 f"batches of {LABEL_BATCH}")
        res = train_labeler_on_card(name, model_type, (train_ds, val_ds,
                                    (make(va, 2), post, va, annos)), logger, root, device)
        inputs, labels = check_batch(make(tr, 3), res["inputs_fn"], CHECK_SETS)
        t1 = time.perf_counter()
        res["reading"]["cpu_check"] = check_labeler_step_against_cpu(
            name, res["model"], res["loss_fn"], inputs, labels, device)
        res["reading"]["cpu_check_s"] = time.perf_counter() - t1
        out[name] = res
    return out


def phase_offboard(device, cfg, weights: dict) -> dict:
    """8: the labelers trained on the card (8(a)), then the Waymo PP detector, from
    ``weights`` (phase 6's snapshot), trained in rounds on a bus-sized segment until
    the chain it feeds labels a static box (at most ``CHAIN_MAX_STEPS`` steps); then
    ``measure`` of the whole chain with the launch counters set to 0 just before the
    timed pass. The rounds run under ``deterministic``: from the snapshot their
    detections, and so the number of rounds the chain needs, are the same in every run
    (before, from phase 6's last weights, one run in five needed more than the cap)."""
    from tdal_torch.data.detection import DetectionDataset
    from tdal_torch.data.synthetic import make_synthetic_dataset
    from tdal_torch.data.waymo_schema import AnnoStore, reorganize_info
    from tdal_torch.models.builder import (
        build_assigner, build_detector, build_test_cfg, build_voxel_config,
    )
    from tdal_torch.ops import conv3x3 as cv
    from tdal_torch.ops import fused_pointnet as fp
    from tdal_torch.pipeline.detector_run import run_inference, train_detector
    from tdal_torch.pipeline.offboard import label_chain, measure
    from tdal_torch.runtime.schedules import adam_with_schedule
    from tdal_torch.runtime.train_state import TrainState

    logger = logging.getLogger("chip_smoke")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        labelers = phase_labelers(device, root / "labelers", logger)
        out["labelers"] = {k: v["reading"] for k, v in labelers.items()}
        out["labelers_s"] = time.perf_counter() - t0
        chain_labelers = tuple((labelers[k]["model"], labelers[k]["inputs_fn"],
                                labelers[k]["kind"]) for k in ("static", "dynamic"))

        t0 = time.perf_counter()
        voxel_cfg = build_voxel_config(cfg.voxel_generator, train=True)
        model = build_detector(cfg.model, voxel_cfg, device=device)
        model.load_state_dict(weights)
        assigner = build_assigner(cfg.assigner, model)
        test_vox = build_voxel_config(cfg.voxel_generator, train=False)
        infer_model = build_detector(cfg.model, test_vox, device=device)  # the test pillars
        test_cfg = build_test_cfg(dict(cfg.test_cfg, score_threshold=CHAIN_SCORE_THRESHOLD),
                                  model, test_vox)

        def segment(sub, seg):
            infos, _ = make_synthetic_dataset(root / sub, **seg)
            info_map = reorganize_info(infos)
            ds = DetectionDataset(infos, cfg.class_names, assigner, test_vox, mode="val",
                                  max_points=cfg.data["val"]["max_points"],
                                  shuffle_points=False)
            return infos, (ds, info_map, AnnoStore(info_map))

        infos, seg = segment("chain", CHAIN_SEGMENT)
        _, warm_seg = segment("chain_warm", CHAIN_WARM_SEGMENT)
        train_ds = DetectionDataset(infos, cfg.class_names, assigner, voxel_cfg, mode="train",
                                    max_points=cfg.data["train"]["max_points"],
                                    global_rot_noise=(0.0, 0.0),
                                    global_scale_noise=(1.0, 1.0), seed=0)
        # tdal's real-detector test: Adam at 3e-3, the global norm clipped at 35
        opt = adam_with_schedule(model.parameters(), lambda step: 3e-3, 0.0, 35.0)
        state = TrainState(model, opt)
        head = cfg.model["bbox_head"]
        steps_per_epoch = math.ceil(len(train_ds) / PP_BATCH)
        rounds, steps = [], 0
        for k in cv.launches:
            cv.launches[k] = 0
        with deterministic() as named:
            while steps < CHAIN_MAX_STEPS:
                t1 = time.perf_counter()
                epochs = CHAIN_ROUND_STEPS // steps_per_epoch
                train_detector(state, train_ds, head["code_weights"], n_epoch=epochs,
                               batch_size=PP_BATCH, logger=logger,
                               work_dir=root / f"det_round{len(rounds)}", weight=head["weight"],
                               log_every=steps_per_epoch * epochs, seed=len(rounds))
                torch.cuda.synchronize()
                steps += epochs * steps_per_epoch
                train_s = time.perf_counter() - t1
                shutil.rmtree(root / f"det_round{len(rounds)}")  # its checkpoint per epoch
                infer_model.load_state_dict(model.state_dict())
                detections = run_inference(TrainState(infer_model, None), seg[0], test_cfg,
                                           PP_BATCH, logger)
                res = label_chain(detections,
                                  seg[1], seg[2], chain_labelers, root / f"round{len(rounds)}",
                                  logger, device=device, **CHAIN_KW)
                rounds.append(dict(steps=steps, train_s=train_s, counts=res["counts"]))
                log(f"  detector round {len(rounds)}: {steps} steps in all ({train_s:.1f} s for "
                    f"this round's {epochs * steps_per_epoch}); chain counts {res['counts']}")
                if res["counts"]["static_boxes_labeled"] > 0:
                    break
        log(f"  the rounds ran under deterministic algorithms; ops without a deterministic "
            f"version: {named or 'none'}")
        conv_launches = dict(cv.launches)
        per_step = {k: v / steps for k, v in conv_launches.items()}
        for k, v in conv_launches.items():
            if v != steps * PP_LAUNCHES[k]:
                raise AssertionError(f"{k}: {v} launches in {steps} chain training steps, "
                                     f"expected {PP_LAUNCHES[k]} per step")
        out.update(detector_steps=steps, rounds=rounds, conv_launches=conv_launches,
                   conv_launches_per_step=per_step, detector_s=time.perf_counter() - t0)

        # the whole chain: a warm pass on a shorter segment, then the timed pass with
        # the launch counters set to 0 just before it
        def zero_counts():
            for k in fp.launches:
                fp.launches[k] = 0

        t0 = time.perf_counter()
        infer_model.load_state_dict(model.state_dict())
        measured = measure(TrainState(infer_model, None), test_cfg, seg, warm_seg,
                           chain_labelers, root / "measure", logger, before_timed=zero_counts,
                           batch_size=PP_BATCH, **CHAIN_KW)
        torch.cuda.synchronize()
        k_launches = dict(fp.launches)
        counts = measured["counts"]
        log(f"  chain: {measured['frames_per_sec']:.3f} frames/s over {measured['n_frames']} "
            f"frames ({measured['total_s']:.3f} s; stages "
            f"{ {k: round(v, 4) for k, v in measured['stage_s'].items()} }); counts {counts}; "
            f"warm counts {measured['warm_counts']}; K1/K2 launches {k_launches} for "
            f"{counts['predict_batches']} predict batches; whole measure "
            f"{time.perf_counter() - t0:.1f} s")
        if not counts["static_boxes_labeled"] > 0:
            raise AssertionError(f"the detector-fed chain labeled no static box: {counts}")
        for k, v in k_launches.items():
            if v != counts["predict_batches"]:
                raise AssertionError(f"{k}: {v} launches for {counts['predict_batches']} "
                                     f"predict batches")
        boxes = measured["result"]["boxes"]
        for kind, b in boxes.items():
            if not (np.isfinite(b).all() and b.shape[1] == 7):
                raise AssertionError(f"{kind} boxes not finite or not (n, 7): {b.shape}")
        out.update(frames_per_s=measured["frames_per_sec"], total_s=measured["total_s"],
                   stage_s=measured["stage_s"], counts=counts,
                   warm_counts=measured["warm_counts"], k1k2_launches=k_launches,
                   metrics=measured["result"]["metrics"])
    return out


# ---------------------------------------------------------------------------
# phase 9: sparse VoxelNet training and inference, and the frozen-first-stage
# two-stage detector, on the Waymo configs
# ---------------------------------------------------------------------------

VN_CONFIG = Path("configs/waymo/voxelnet/waymo_centerpoint_voxelnet_3x.py")
VN_TWO_STAGE = Path("configs/waymo/voxelnet/two_stage/"
                    "waymo_centerpoint_voxelnet_two_stage_bev_5point_ft_6epoch_freeze.py")
VN_DATA = dict(n_scenes=1, n_frames=8, seed=0, n_static=10, n_dynamic=10,
               points_per_object=256, n_background=160000)
# 12 test frames (24 until phase 12 joined the script, which then ran past 900 s)
VN_TEST_DATA = dict(VN_DATA, n_frames=12, seed=1)
VN_BATCH, VN_WARM_EPOCHS, VN_TIMED_EPOCHS = 4, 1, 2
VN_TIMED = VN_TIMED_EPOCHS * VN_DATA["n_frames"] // VN_BATCH  # steps
VN_CHECK_BATCH = 2  # the card-vs-CPU step check's batch: the CPU copy at the full grid
VN_MIN_POINTS, VN_MIN_VOXELS = 150000, 100000  # each training frame holds at least
# the 13 stride-1 3x3 sites of the VoxelNet RPN and head: stage 1's entry (384->128,
# 188^2) and its 5 layers (128->128), stage 2's 5 layers (256->256, 94^2) after its
# strided entry, the head's shared conv (512->64) and the SepHead's fused first conv
# (64->320). 10 take their producer's BN + ReLU (chained: K7 is their dgrad), the
# entry, stage 2's first layer and the shared conv do not (K4)
VN_SITES, VN_CHAINED = 13, 10
VN_LAUNCHES = {"conv3x3_fwd_stats": VN_SITES, "conv3x3_fwd": VN_SITES - VN_CHAINED,
               "conv3x3_dgrad_act": VN_CHAINED, "conv3x3_wgrad": VN_SITES}
# the profiled step's device time by kernel name, first match first: the sparse
# backbone's gather-GEMM kernel (its forward and dgrad), the conv kernels K3-K7, the
# sparse backbone's matmuls (cuBLAS's GEMMs of its d W, the only ones of the step),
# cuDNN's convs, the sparse backbone's gathers (index_select: its d W's) and its sort /
# search / scan kernels
# the sparse gather-GEMM kernel's launches: an eval forward makes one a sparse conv; a
# train step adds the dgrads but the input conv's (its features need no gradient)
VN_SPARSE_FORWARD, VN_SPARSE_STEP = 21, 41
VN_CATEGORIES = (
    ("sparse: gather-GEMM kernel", ("sparse_conv_kernel",)),
    ("conv kernels K3-K7", CONV_KERNEL_NAMES),
    ("sparse: matmuls", ("cublas", "sgemm")),
    ("cuDNN convs", ("conv", "fprop", "dgrad", "wgrad", "cudnn", "xmma_", "implicit")),
    ("sparse: gathers", ("index", "gather")),
    ("sparse: sort / search / scan", ("sort", "search", "scan", "radix", "cub::")),
)


def device_time_by_category(step, state, batch) -> dict:
    """One train step under ``torch.profiler``: device ms by ``VN_CATEGORIES`` (first
    matching name wins; the rest is everything else: BN, ReLU, losses, AdamW), the busy
    time and the device's idle share of the step's synchronised wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    cats = {name: 0.0 for name, _ in VN_CATEGORIES}
    cats["rest"] = 0.0
    spans, by_name = [], {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        r = evt.time_range
        ms = (r.end - r.start) / 1e3
        spans.append((r.start, r.end))
        by_name[evt.name] = by_name.get(evt.name, 0.0) + ms
        low = evt.name.lower()
        cat = next((name for name, keys in VN_CATEGORIES
                    if any(k.lower() in low for k in keys)), "rest")
        cats[cat] += ms
    if not spans:
        log("  torch.profiler showed no device time on this machine")
        return dict(device_events=0, wall_ms=wall_ms)
    busy_ms = union_ms(spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    log(f"  profiled step: {wall_ms:.1f} ms wall (profiler on), device busy {busy_ms:.1f} "
        f"ms, idle share {1 - busy_ms / wall_ms:.3f}; device ms by category: "
        + ", ".join(f"{k} {v:.1f}" for k, v in cats.items()))
    for k, v in top:
        log(f"    {v:9.3f} ms  {k[:110]}")
    return dict(device_events=len(spans), wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=1 - busy_ms / wall_ms, by_category_ms=cats,
                top=[(k[:120], v) for k, v in top])


def sparse_launches() -> int:
    """The sparse gather-GEMM kernel's launches so far (``tracing``'s
    ``sparse_conv.launches``); a path's count is the difference across it."""
    from tdal_torch.runtime import tracing

    return tracing.counters().get("sparse_conv.launches", 0)


def expect_sparse_launches(path: str, n: int, per: int, times: int):
    """``path`` made ``n`` sparse kernel launches: ``per`` each of ``times`` runs."""
    log(f"  sparse gather-GEMM launches, {path}: {n} ({per} each of {times})")
    if n != per * times:
        raise AssertionError(f"{path}: {n} sparse kernel launches, expected {per} each of "
                             f"{times}")


@contextlib.contextmanager
def subm_backward_drops_a_tap(tap: int = 4):
    """A wrong backward for a control: every submanifold conv's d feats leaves out one
    tap's term."""
    from tdal_torch.ops import sparse_conv as sc

    fn = sc._GatherConv
    original = fn.__dict__["backward"]

    def backward(ctx, g):
        if not ctx.subm:
            return original.__func__(ctx, g)
        feats, weights, fwd, _, n_in = ctx.saved_tensors
        w = weights.flip(0).transpose(1, 2).clone()
        w[tap] = 0
        dfeats = (sc._contract(g, fwd, w, n_in).to(feats.dtype)
                  if ctx.needs_input_grad[0] else None)
        return (dfeats, sc._wgrad(feats, fwd, g).to(weights.dtype), None, None, None, None)

    fn.backward = staticmethod(backward)
    try:
        yield
    finally:
        fn.backward = original


@contextlib.contextmanager
def unbiased_running_variance():
    """A wrong BatchNorm for a control: ``BatchNorm`` and ``MaskedBatchNorm`` feed the
    unbiased batch variance (n / (n - 1), torch's ``nn.BatchNorm*``) to their running
    variance."""
    from tdal_torch.models import layers

    original = layers.update_running

    def update_running(module, mean, var):
        if isinstance(module, layers.BatchNorm) and module.training:
            var = var * (module._rows / (module._rows - 1.0))
        original(module, mean, var)

    def counting(forward):
        def wrapped(self, x, *args):
            mask = args[0] if args else None
            self._rows = (mask.sum(dim=tuple(range(mask.dim()))).float()
                          if mask is not None else x.numel() / x.shape[-1])
            return forward(self, x, *args)
        return wrapped

    fwd_bn, fwd_mbn = layers.BatchNorm.forward, layers.MaskedBatchNorm.forward
    layers.update_running = update_running
    layers.BatchNorm.forward = counting(fwd_bn)
    layers.MaskedBatchNorm.forward = counting(fwd_mbn)
    try:
        yield
    finally:
        layers.update_running = original
        layers.BatchNorm.forward, layers.MaskedBatchNorm.forward = fwd_bn, fwd_mbn


def occupancy_report(model) -> list:
    """The sparse backbone's occupied voxels per sample at each level of its last
    forward, against each level's cap; logged."""
    names = ["input", "level 1", "level 2", "level 3", "z-compressed"]
    rows = []
    for name, (counts, cap) in zip(names, model.backbone.occupancy):
        c = [int(v) for v in counts.cpu()]
        rows.append(dict(level=name, voxels=c, cap=cap))
        log(f"    {name}: {c} of {cap}" + (" (overflow: the lowest keys kept)"
                                             if max(c) >= cap else ""))
    return rows


def voxelnet_training(root: Path):
    """The Waymo VoxelNet config's detector (fresh init from seed 0) on the card, its
    train state and a synthetic training set under ``root``."""
    from tdal_torch.data.detection import DetectionDataset
    from tdal_torch.data.synthetic import make_synthetic_dataset
    from tdal_torch.models.builder import build_assigner, build_detector, build_voxel_config
    from tdal_torch.runtime.config import Config
    from tdal_torch.runtime.schedules import adam_with_schedule, one_cycle
    from tdal_torch.runtime.train_state import TrainState, param_count

    cfg = Config.fromfile(VN_CONFIG)
    voxel_cfg = build_voxel_config(cfg.voxel_generator, train=True)
    model = build_detector(cfg.model, voxel_cfg, seed=0)
    pre = cfg.train_preprocessor
    total_steps = VN_DATA["n_frames"] // VN_BATCH * cfg.total_epochs
    lr, mom = one_cycle(cfg.lr_config["lr_max"], total_steps, tuple(cfg.lr_config["moms"]),
                        cfg.lr_config["div_factor"], cfg.lr_config["pct_start"])
    opt = adam_with_schedule(model.parameters(), lr, cfg.optimizer["wd"],
                             cfg.grad_clip["max_norm"], mom)
    log(f"  {VN_CONFIG}: {param_count(model)} parameters, grid "
        f"{tuple(int(g) for g in voxel_cfg.grid_size)} (x, y, z), {voxel_cfg.max_voxels} "
        f"voxels, BEV {model.backbone.out_channels} channels into the RPN, "
        f"{model.rpn.out_channels} out; batch {VN_BATCH}, f32")
    t0 = time.perf_counter()
    infos, _ = make_synthetic_dataset(root / "data", **VN_DATA)
    ds = DetectionDataset(
        infos, cfg.class_names, build_assigner(cfg.assigner, model), voxel_cfg, mode="train",
        max_points=cfg.data["train"]["max_points"],
        global_rot_noise=tuple(pre["global_rot_noise"]),
        global_scale_noise=tuple(pre["global_scale_noise"]),
        shuffle_points=pre["shuffle_points"], seed=0)
    log(f"  {len(ds)} synthetic frames written in {time.perf_counter() - t0:.1f} s")
    return cfg, model, TrainState(model, opt), ds, total_steps


def phase_voxelnet_train(device, root: Path) -> tuple:
    """(a): VoxelNet training at the Waymo config's width, batch 4, through
    ``train_detector``; the step alone, a profiled step, and one step against a CPU
    copy with two controls."""
    from tdal_torch.data.detection import collate_detection
    from tdal_torch.ops import conv3x3 as cv
    from tdal_torch.pipeline.detector_engine import make_detector_steps
    from tdal_torch.pipeline.detector_run import train_detector

    logger = logging.getLogger("chip_smoke")
    cfg, model, state, ds, total_steps = voxelnet_training(root)
    head = cfg.model["bbox_head"]
    batch = collate_detection([ds[i] for i in range(VN_BATCH)])
    n_points = [int(np.isfinite(p[:, 0]).sum()) for p in batch["points"]]
    model.eval()
    with torch.no_grad():
        model(torch.as_tensor(batch["points"], device=device))
    log(f"  points per frame {n_points}; occupied voxels by backbone level, against caps:")
    occupancy = occupancy_report(model)
    if min(occupancy[0]["voxels"]) < VN_MIN_VOXELS or min(n_points) < VN_MIN_POINTS:
        raise AssertionError(f"a frame has fewer than {VN_MIN_POINTS} points or {VN_MIN_VOXELS} "
                             f"voxels: {n_points}, {occupancy[0]}")

    def run(tag, epochs):
        work = root / tag
        t0 = time.perf_counter()
        train_detector(state, ds, head["code_weights"], n_epoch=epochs, batch_size=VN_BATCH,
                       logger=logger, work_dir=work, weight=head["weight"], log_every=1)
        torch.cuda.synchronize()
        rows = [json.loads(line) for line in
                (work / "logs" / "metrics.jsonl").read_text().splitlines()]
        return time.perf_counter() - t0, rows

    # the warm epoch's end, reached through deterministic algorithms only, is (c)'s first
    # stage: (c)'s check is then a function of the code, not of the run
    with deterministic() as named:
        warm_s, warm_rows = run("warm", VN_WARM_EPOCHS)
    snapshot = copy.deepcopy(model).cpu()
    log(f"  warm epoch under deterministic algorithms in {warm_s:.1f} s (its end is (c)'s "
        f"first stage); ops without a deterministic version: {named or 'none'}")
    torch.cuda.reset_peak_memory_stats()
    for k in cv.launches:
        cv.launches[k] = 0
    s0 = sparse_launches()
    timed_s, rows = run("timed", VN_TIMED_EPOCHS)
    launches = dict(cv.launches)
    sparse = sparse_launches() - s0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [r["loss"] for r in warm_rows + rows]
    log(f"  losses {losses}")
    if not all(math.isfinite(v) for v in losses) or len(rows) != VN_TIMED:
        raise AssertionError(f"non-finite or missing losses: {losses}")
    log(f"  conv kernel launches per step: { {k: v / VN_TIMED for k, v in launches.items()} } "
        f"(expected {VN_LAUNCHES}: {VN_SITES} stride-1 3x3 sites, {VN_CHAINED} chained)")
    for name, n in launches.items():
        if n != VN_TIMED * VN_LAUNCHES[name]:
            raise AssertionError(f"{name}: {n} launches in {VN_TIMED} steps, expected "
                                 f"{VN_LAUNCHES[name]} per step")
    expect_sparse_launches("phase 9 (a) timed steps", sparse, VN_SPARSE_STEP, VN_TIMED)
    step = make_detector_steps(model, head["code_weights"], head["weight"])
    step_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    step_ms = 1e3 * statistics.median(step_s)
    profiled = device_time_by_category(step, state, batch)
    # the sparse backbone alone, forward and backward of its BEV (train mode; its
    # running statistics restored after)
    from tdal_torch.core.voxel import voxelize_batch

    backbone, saved = model.backbone, copy.deepcopy(model.backbone.state_dict())
    with torch.no_grad():
        pts = torch.as_tensor(batch["points"], device=device)
        vox, coords, num, n_vox = voxelize_batch(pts, model.voxel_cfg)
        feats = model.reader(vox, num)
        valid = torch.arange(feats.shape[1], device=device)[None, :] < n_vox[:, None]
    backbone_s = []
    backbone.train()
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bev = backbone(feats * valid[..., None], coords, valid)
        bev.backward(torch.ones_like(bev))
        torch.cuda.synchronize()
        backbone_s.append(time.perf_counter() - t0)
    model.zero_grad(set_to_none=True)
    backbone.load_state_dict(saved)
    backbone_ms = 1e3 * statistics.median(backbone_s[1:])
    frames_per_s = VN_TIMED * VN_BATCH / timed_s
    log(f"  train_detector: {VN_TIMED} steps in {timed_s:.3f} s (host data, logging and a "
        f"checkpoint an epoch included), {frames_per_s:.2f} training frames/s; step alone "
        f"{step_ms:.1f} ms (median of 3: {', '.join(f'{1e3 * v:.1f}' for v in step_s)}); "
        f"the sparse backbone alone, forward + backward, {backbone_ms:.1f} ms "
        f"({100 * backbone_ms / step_ms:.0f}% of the step, synchronised apart); peak memory "
        f"{peak_gib:.2f} GiB; warm-up {warm_s:.1f} s")

    check = check_step_with_controls(
        model, first_frames(batch, VN_CHECK_BATCH), device, cfg, total_steps,
        {"subm backward drops a tap": (model, subm_backward_drops_a_tap, "grad_err_over_tol"),
         # n / (n - 1) moves a running variance (momentum 0.01) by a few f32 steps only
         # where n is small: the deepest sparse levels (about 3e4 valid rows) show it
         # against the statistics' own noise floor
         "unbiased running variance": (model, unbiased_running_variance,
                                       "stat_err_over_tol")},
        stat_noise=True, name="phase 9 (a)'s card-vs-CPU step")
    out = dict(launches=launches, launches_per_step=VN_LAUNCHES, sparse_launches=sparse,
               losses=losses, step_ms=step_ms, step_s=step_s, timed_s=timed_s, frames_per_s=frames_per_s,
               backbone_ms=backbone_ms, peak_gib=peak_gib, occupancy=occupancy,
               points_per_frame=n_points, profiled_step=profiled,
               check_batch=VN_CHECK_BATCH, check=check)
    return out, cfg, model, ds, snapshot


def phase_voxelnet_infer(device, cfg, trained, root: Path) -> dict:
    """(b): ``run_inference`` at the config's test settings (400000 voxels, NMS pre 4096
    / post 500 at IoU 0.7, score 0.1) with (a)'s weights; one batch against a CPU copy."""
    from tdal_torch.data.detection import DetectionDataset
    from tdal_torch.data.synthetic import make_synthetic_dataset
    from tdal_torch.models.builder import (
        build_assigner, build_detector, build_test_cfg, build_voxel_config,
    )
    from tdal_torch.models.center_head import predict
    from tdal_torch.pipeline.detector_run import run_inference
    from tdal_torch.runtime.train_state import TrainState

    logger = logging.getLogger("chip_smoke")
    timing = _Records("Total time per frame")
    logger.addHandler(timing)
    voxel_cfg = build_voxel_config(cfg.voxel_generator, train=False)
    model = build_detector(cfg.model, voxel_cfg, device=device, seed=0)
    model.load_state_dict(trained.state_dict())
    test_cfg = build_test_cfg(cfg.test_cfg, model, voxel_cfg)
    try:
        infos, _ = make_synthetic_dataset(root / "test", **VN_TEST_DATA)
        ds = DetectionDataset(infos, cfg.class_names, build_assigner(cfg.assigner, model),
                              voxel_cfg, mode="test", max_points=cfg.data["val"]["max_points"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        s0 = sparse_launches()
        t0 = time.perf_counter()
        dets = run_inference(TrainState(model, None), ds, test_cfg, INFER_BATCH, logger,
                             speed_test=True)
        total = time.perf_counter() - t0
        sparse = sparse_launches() - s0
        s_per_frame = timing.records.pop().args[0]
    finally:
        logger.removeHandler(timing)
    kept = [len(d["scores"]) for d in dets.values()]
    if len(dets) != len(ds) or not all(np.isfinite(d["box3d_lidar"]).all()
                                       and d["box3d_lidar"].shape[1] == 7
                                       for d in dets.values()):
        raise AssertionError("detections missing, not finite or not 7 wide")
    expect_sparse_launches("phase 9 (b) run_inference", sparse, VN_SPARSE_FORWARD,
                           -(-len(ds) // INFER_BATCH))
    out = dict(frames_per_s=1.0 / s_per_frame, s_per_frame=s_per_frame, total_s=total,
               kept_per_frame=float(np.mean(kept)), sparse_launches=sparse,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    points = torch.as_tensor(np.stack([ds[i]["points"] for i in range(INFER_BATCH)]),
                             device=device)
    fwd, post = [], []
    with torch.no_grad():
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            maps = model(points)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            predict(maps, test_cfg, model.num_classes)
            torch.cuda.synchronize()
            fwd.append(t1 - t0)
            post.append(time.perf_counter() - t1)
    out["forward_ms_per_batch"] = 1e3 * statistics.median(fwd[1:])
    out["nms_ms_per_frame"] = 1e3 * statistics.median(post[1:]) / INFER_BATCH
    log(f"  run_inference: {out['frames_per_s']:.3f} frames/s (middle third, synchronised; "
        f"{s_per_frame:.6f} s per frame), {len(ds)} frames in {total:.2f} s with the host "
        f"data; kept boxes per frame {out['kept_per_frame']:.1f}; peak memory "
        f"{out['peak_gib']:.2f} GiB; one batch of {INFER_BATCH}: forward "
        f"{out['forward_ms_per_batch']:.1f} ms, decode + NMS {out['nms_ms_per_frame']:.1f} ms "
        f"per frame (medians of 3)")
    log(f"  test voxels by backbone level (the last batch), against caps:")
    out["occupancy"] = occupancy_report(model)
    out["cpu_check"] = check_infer_against_cpu(model, points[:VN_CHECK_BATCH], test_cfg)
    out["sparse_kernel"] = sparse_kernel_check(model, points)
    return out


# the 21 sparse convs of an eval forward of the VoxelNet backbone, in order
VN_SPARSE_CONVS = (["in L0"] + ["subm L0"] * 4 + ["down L1"] + ["subm L1"] * 4 + ["down L2"]
                   + ["subm L2"] * 4 + ["down L3"] + ["subm L3"] * 4 + ["z L4"])
SPARSE_TOL = 1e-5  # kernel against twin, f32: the same products summed in another order
SPARSE_SOURCE = "tdal_torch/ops/csrc/sparse_conv.cu"
SPARSE_REPLACES = ("no TPU kernel: tdal/ops/sparse_conv.py leaves the contraction to XLA; "
                   "the port's per-tap index_select + addmm path (now its CPU twin)")
F32_FFMA_FLOPS = 67e12  # an H100 SXM's f32 rate outside the tensor cores (data sheet)


def sparse_kernel_check(model, points) -> dict:
    """The sparse gather-GEMM kernel at the backbone's own shapes: one eval forward of
    ``points`` captures its 21 forward contractions (features, table, weights, occupied
    counts); each is then timed (the kernel alone, back to back, and its plain twin,
    the per-tap path) beside its least time as the benchmark's ``sparse_conv_roofline``
    counts it (2 Cin Cout FLOP a real pair against 495 TFLOP/s, the rows it reads and
    writes and its weights once against 3.35 TB/s) and the f32 FFMA time of its real
    pairs (67 TFLOP/s), and held against the twin: 1e-5 of max(1, |twin|)."""
    from tdal_torch.ops import build
    from tdal_torch.ops import sparse_conv as sc

    calls, real = [], sc.gather_gemm

    def capture(feats, table, weights, counts):
        calls.append((feats, table, weights, counts))
        return real(feats, table, weights, counts)

    sc.gather_gemm = capture
    try:
        with torch.no_grad():
            model(points)
    finally:
        sc.gather_gemm = real
    if len(calls) != len(VN_SPARSE_CONVS):
        raise AssertionError(f"{len(calls)} sparse convs in a forward, expected "
                             f"{len(VN_SPARSE_CONVS)}")
    lib = build.kernels()
    rows, failed = [], []
    log(f"  the sparse gather-GEMM kernel at the backbone's shapes (batch {points.shape[0]}; "
        f"ms: kernel, least, f32 FFMA time of the real pairs, twin):")
    for name, (x, table, w, counts) in zip(VN_SPARSE_CONVS, calls):
        (n_in, cin), (taps, n_out), cout = x.shape, table.shape, w.shape[2]
        w = w.detach()
        wk = w.to(x.dtype).float().contiguous()
        out = torch.empty(n_out, cout, dtype=x.dtype, device=x.device)
        rows_tile = sc.tile_rows(cout)
        ms = time_back_to_back(lambda: lib.sparse_conv(x, table, wk, counts, out))
        twin_ms = time_ms(lambda: sc._pertap(x, table, w), reps=5, warm=1)
        abs_err, err = rel_err(real(x, table, w, counts).float(),
                               sc._pertap(x, table, w).float())
        hit = table != n_in
        pairs = int(hit.sum())
        flop = 2.0 * pairs * cin * cout
        nbytes = 4.0 * (int(torch.unique(table[hit]).numel()) * cin + int(counts.sum()) * cout
                        + taps * cin * cout)
        least_ms = 1e3 * max(flop / 495e12, nbytes / 3.35e12)
        tiles = taps * -(-n_out // rows_tile)
        load = 100.0 * int(sc.tile_taps_loaded(hit.t()[None], rows_tile)) / tiles
        r = dict(conv=name, rows=n_out, occupied=int(counts.sum()), cin=cin, cout=cout,
                 taps=taps, pairs=pairs, flop=flop, bytes=nbytes, kernel_ms=ms,
                 least_ms=least_ms, ffma_ms=1e3 * flop / F32_FFMA_FLOPS, twin_ms=twin_ms,
                 fill=100.0 * pairs / hit.numel(), tile_load=load, abs_err=abs_err,
                 rel_err=err)
        rows.append(r)
        log(f"    {name}: {n_out} rows, {r['occupied']} occupied, {cin}->{cout} x {taps}, "
            f"{pairs} pairs (fill {r['fill']:.2f}%, tile load {load:.2f}%): {ms:.3f} ms, "
            f"least {least_ms:.4f}, FFMA {r['ffma_ms']:.3f}, twin {twin_ms:.2f}; "
            f"rel err {err:.2e}")
        if not err <= SPARSE_TOL:
            failed.append(name)
        del out
    total = {k: sum(r[k] for r in rows) for k in ("kernel_ms", "least_ms", "ffma_ms",
                                                  "twin_ms")}
    log(f"  sparse convs of a forward: kernel {total['kernel_ms']:.2f} ms, least "
        f"{total['least_ms']:.3f} ms ({100 * total['least_ms'] / total['kernel_ms']:.2f}% of "
        f"the kernel's), FFMA {total['ffma_ms']:.2f} ms, twin {total['twin_ms']:.1f} ms")
    if failed:
        raise AssertionError(f"the sparse kernel against its twin, past {SPARSE_TOL}: {failed}")
    return dict(convs=rows, max_abs_err=max(r["abs_err"] for r in rows),
                max_rel_err=max(r["rel_err"] for r in rows), **total)


# the RoI head step, card against CPU: the loss and the gradients (f32 matmuls over
# 2560 inputs and BatchNorms over 512 rows, summed in another order) 1e-4 of the leaf's
# largest; the running statistics 1e-5 (f32 sums over 512 rows: about 1e-7 on an
# H100), which the unbiased variance (512 / 511, momentum 0.1: 1e-4 to 4e-4) fails
ROI_TOL = {"loss_rel_err": 1e-4, "grad_rel_err": 1e-4, "stat_rel_err": 1e-5}
# a ReLU whose input the card and the CPU see on either side of 0 is a knife edge only
# within ROI_KNIFE of 0, and only while they are at most ROI_KNIFE_SHARE of the head's
# ReLU units (6 layers of 256 over the step's 512 RoIs: 786432): its input is a BatchNorm
# output (unit scale) of f32 sums over up to 2560 products, which the two devices round
# about 1e-6 apart. Read on an H100 80GB HBM3 with the sparse gather-GEMM kernel in the
# first stage: 22 units (2.8e-5 of them), the farthest 1.6e-7 from 0
ROI_KNIFE, ROI_KNIFE_SHARE = 1e-6, 1e-3


def roi_step(engine, rois, labels, scores, feats, gt, draws, device, relu_masks=None):
    """One RoI head step on ``device`` from the first stage's outputs: (loss, the RoI
    head's gradients, its state after the update, each Linear + BatchNorm + ReLU layer's
    ReLU input) in float64 on the CPU. With ``relu_masks`` (a bool tensor a layer, in
    that order) each of those ReLUs passes exactly where its mask says: another
    device's pattern."""
    from tdal_torch.models.two_stage import proposal_targets, roi_losses
    from tdal_torch.runtime.schedules import adam_with_schedule

    head = copy.deepcopy(engine.roi_head).to(device).train()
    opt = adam_with_schedule(head.parameters(), lambda n: 1e-3, 0.01, 35.0)
    mv = lambda t: t.to(device)  # noqa: E731
    layers = [layer for group in (head.shared, head.cls_layers, head.reg_layers)
              for layer in group]
    pre = [None] * len(layers)
    for i, layer in enumerate(layers):
        def keep(_, __, out, i=i):
            pre[i] = out

        def relu(_, __, out, i=i):
            return pre[i] * mv(relu_masks[i]).to(pre[i].dtype)

        layer.bn.register_forward_hook(keep)
        if relu_masks is not None:
            layer.register_forward_hook(relu)
    targets = proposal_targets(mv(draws["proposal"]), mv(rois), mv(scores), mv(labels),
                               mv(feats), mv(gt), engine.roi_cfg)
    cls, reg = head(targets["roi_features"], dropout=[mv(m) for m in draws["dropout"]])
    cls_loss, reg_loss = roi_losses(cls, reg, targets, engine.code_weights_roi)
    total = cls_loss + reg_loss
    total.backward()
    grads = {k: p.grad.detach().cpu().double() for k, p in head.named_parameters()}
    opt.step()
    return (float(total.detach()), grads,
            {k: v.detach().cpu().double() for k, v in head.state_dict().items()},
            [p.detach().cpu().double() for p in pre])


def phase_two_stage(device, trained, ds_train, root: Path) -> dict:
    """(c): the freeze config at full width, its first stage bf16 from (a)'s snapshot:
    RoI head training, the first stage unchanged, predict, and one RoI head step
    against a CPU copy fed the same RoIs, features, draws and dropout masks. All of it
    runs under ``deterministic``, so the check's inputs, and its verdict, are the same
    in every run (before, from (a)'s last weights, a ReLU on a knife edge failed it in
    one run of about ten)."""
    from tdal_torch.data.detection import collate_detection
    from tdal_torch.models.builder import (
        build_detector, build_test_cfg, build_two_stage_engine, build_voxel_config,
    )
    from tdal_torch.pipeline.two_stage_engine import make_two_stage_steps
    from tdal_torch.pipeline.two_stage_run import train_two_stage
    from tdal_torch.runtime.config import Config
    from tdal_torch.runtime.schedules import adam_with_schedule, one_cycle
    from tdal_torch.runtime.train_state import TrainState, param_count

    logger = logging.getLogger("chip_smoke")
    cfg = Config.fromfile(VN_TWO_STAGE)
    voxel_cfg = build_voxel_config(cfg.voxel_generator, train=True)
    first = build_detector(cfg.model["first_stage_cfg"], voxel_cfg, device="cpu")
    test_cfg = build_test_cfg(cfg.test_cfg, first, voxel_cfg)
    del first
    engine = build_two_stage_engine(cfg.model, voxel_cfg, test_cfg, seed=0)
    engine.first.load_state_dict(trained.state_dict())
    total_steps = 4
    lr, mom = one_cycle(cfg.lr_config["lr_max"], total_steps)
    opt = adam_with_schedule(engine.trainable_parameters(), lr, cfg.optimizer["wd"],
                             cfg.grad_clip["max_norm"], mom)
    state = TrainState(engine, opt)
    n_head = param_count(engine.roi_head)
    log(f"  {VN_TWO_STAGE}: first stage {engine.first.rpn.dtype}, RoIHead input "
        f"{engine.roi_head.shared[0].linear.in_features}, {engine.roi_cfg.roi_per_image} "
        f"RoIs an image, {n_head} RoI head parameters (the optimizer's), "
        f"{param_count(engine) - n_head} frozen")
    with deterministic() as named:
        first_before = {k: v.clone() for k, v in engine.first.state_dict().items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        s0 = sparse_launches()
        t0 = time.perf_counter()
        train_two_stage(state, ds_train, 1, VN_BATCH, logger, root / "two_stage", log_every=1)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        sparse = sparse_launches() - s0
        expect_sparse_launches("phase 9 (c) train_two_stage, the frozen first stage", sparse,
                               VN_SPARSE_FORWARD, len(ds_train) // VN_BATCH)
        batch = collate_detection([ds_train[i] for i in range(VN_BATCH)])
        train_step, predict_step = make_two_stage_steps(engine)
        gen = torch.Generator().manual_seed(0)
        step_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            logs = train_step(state, batch, generator=gen)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        changed = [k for k, v in engine.first.state_dict().items()
                   if not torch.equal(v, first_before[k])]
        if changed or not math.isfinite(float(logs["loss"])):
            raise AssertionError(f"the frozen first stage changed ({changed[:5]}) or the loss "
                                 f"is not finite ({float(logs['loss'])})")
        points = torch.as_tensor(batch["points"], device=device)
        pred_s = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            preds = predict_step(state, points)
            torch.cuda.synchronize()
            pred_s.append(time.perf_counter() - t0)
        if not (torch.isfinite(preds["box3d_lidar"]).all() and preds["valid"].any()):
            raise AssertionError("two-stage predictions not finite or empty")
        out = dict(train_s=train_s, sparse_launches=sparse,
                   step_ms=1e3 * statistics.median(step_s), peak_gib=peak_gib,
                   loss=float(logs["loss"]), first_stage_unchanged=True,
                   predict_frames_per_s=VN_BATCH / statistics.median(pred_s[1:]),
                   kept=int(preds["valid"].sum()))
        log(f"  train_two_stage: {len(ds_train) // VN_BATCH} steps in {train_s:.2f} s; RoI head "
            f"step alone {out['step_ms']:.1f} ms (median of 3), loss {out['loss']:.4f}; peak "
            f"memory {peak_gib:.2f} GiB; the first stage's parameters and running statistics "
            f"unchanged; predict {out['predict_frames_per_s']:.2f} frames/s ({out['kept']} "
            f"boxes valid in the batch)")

        # one RoI head step, card against a CPU copy, on the same first-stage outputs
        with torch.no_grad():
            _, rois, labels, scores, feats, _ = engine.first_stage_rois(points, train=False)
        # tdal's slice of the GT rows for a 7-wide code (two_stage_engine._gt_of)
        gt = torch.as_tensor(batch["gt_boxes_and_cls"], device=device)[..., :8]
        draws = engine.draws(rois.shape[0], rois.shape[1], torch.Generator().manual_seed(1))
        first_out = [t.float().cpu() for t in (rois, labels, scores, feats, gt)]
        first_out[1] = labels.cpu()
        card = roi_step(engine, *first_out, draws, device)
        cpu = roi_step(engine, *first_out, draws, torch.device("cpu"))
        # knife edges: ReLUs that the two devices decide apart on inputs within ROI_KNIFE
        # of 0; the CPU copy then takes the card's decisions there
        masks = [p > 0 for p in card[3]]
        flips = [(c > 0) != m for c, m in zip(cpu[3], masks)]
        knife = dict(units=sum(int(f.sum()) for f in flips),
                     of_units=sum(m.numel() for m in masks),
                     largest=max((float(c[f].abs().max()) for c, f in zip(cpu[3], flips)
                                  if f.any()), default=0.0))
        if knife["units"]:
            own = cpu
            cpu = roi_step(engine, *first_out, draws, torch.device("cpu"), relu_masks=masks)
        with unbiased_running_variance():
            control = roi_step(engine, *first_out, draws, device)

    def errors(a, ref=cpu):
        g = max(float((a[1][k] - ref[1][k]).abs().max()) / max(1e-12, float(ref[1][k].abs().max()))
                for k in ref[1])
        st = max(float((a[2][k] - ref[2][k]).abs().max() / ref[2][k].abs().max().clamp_min(1e-6))
                 for k in ref[2] if "running" in k)
        return dict(loss_rel_err=abs(a[0] - ref[0]) / abs(ref[0]), grad_rel_err=g,
                    stat_rel_err=st)

    out["roi_check"], out["roi_control_unbiased"] = errors(card), errors(control)
    out["roi_knife_edges"] = knife
    out["nondeterministic_ops"] = named
    log(f"  one RoI head step on the card against a CPU copy (same RoIs, features, draws "
        f"and dropout masks): {out['roi_check']} (tol: {ROI_TOL}); control with the "
        f"unbiased running variance: {out['roi_control_unbiased']}; (c) ran under "
        f"deterministic algorithms, ops without a deterministic version: {named or 'none'}")
    log(f"  ReLUs decided apart by the card and the CPU: {knife['units']} of "
        f"{knife['of_units']}, inputs within {knife['largest']:.3e} of 0 (knife edges: "
        f"within {ROI_KNIFE} of 0, at most {ROI_KNIFE_SHARE} of the units; the CPU copy "
        f"then takes the card's decisions)" + (f"; with its own: {errors(card, own)}"
                                               if knife["units"] else ""))
    if knife["largest"] > ROI_KNIFE:
        raise AssertionError(f"a ReLU of the RoI head decided apart {knife['largest']:.3e} "
                             f"from 0 on the card and the CPU")
    if knife["units"] > ROI_KNIFE_SHARE * knife["of_units"]:
        raise AssertionError(f"{knife['units']} of {knife['of_units']} ReLUs of the RoI head "
                             f"decided apart on the card and the CPU")
    if not all(out["roi_check"][k] <= tol for k, tol in ROI_TOL.items()):
        raise AssertionError(f"the RoI head step differs from the CPU's: {out['roi_check']}")
    if not out["roi_control_unbiased"]["stat_rel_err"] > ROI_TOL["stat_rel_err"]:
        raise AssertionError("the unbiased-variance control passes the RoI head check")
    return out


def phase_voxelnet(device) -> dict:
    """Phase 9: (a) training, (b) inference, (c) the two-stage detector."""
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        log("  (a) VoxelNet training")
        train, cfg, model, ds, snapshot = phase_voxelnet_train(device, root)
        t_a = time.perf_counter() - t0
        log("  (b) VoxelNet inference")
        infer = phase_voxelnet_infer(device, cfg, model, root)
        t_b = time.perf_counter() - t0 - t_a
        log("  (c) the two-stage detector, first stage frozen")
        two = phase_two_stage(device, snapshot, ds, root)
        t_c = time.perf_counter() - t0 - t_a - t_b
    log(f"  phase 9 seconds: training {t_a:.1f}, inference {t_b:.1f}, two-stage {t_c:.1f}")
    return dict(train=train, infer=infer, two_stage=two, seconds=[t_a, t_b, t_c])


# ---------------------------------------------------------------------------
# phase 10: data parallelism on the card
# ---------------------------------------------------------------------------

DP_WORLD = 2
# (c): the static one-box labeler at its production widths, fresh from seed 0
DP_LABELER_SETS, DP_LABELER_SEED = 8, 5
# the scaling reading of (b) and (d): train steps at the config's samples_per_gpu of 4
# frames a card (a global batch of 4 times the ranks), after warm steps, without
# train_detector's checkpoint writes
DP_PER_CARD, DP_WARM_STEPS, DP_TIMED_STEPS = 4, 2, 12


def dp_labeler_inputs(seed: int = DP_LABELER_SEED):
    """(inputs, labels, draws) of ``DP_LABELER_SETS`` static sets at the production
    widths (4096 points, 512 object points), made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    b, n = DP_LABELER_SETS, NPOINTS_STATIC

    def boxes():
        return np.concatenate([rng.normal(size=(b, 3)), rng.uniform(1, 5, (b, 3)),
                               rng.uniform(-3, 3, (b, 1))], 1).astype(np.float32)

    t = torch.from_numpy
    inputs = [t(rng.normal(size=(b, n, 3)).astype(np.float32)), t(boxes()), t(boxes())]
    labels = {"mask_label": t((rng.random((b, n)) < 0.5).astype(np.float32)),
              "center_label": t(rng.normal(size=(b, 3)).astype(np.float32)),
              "heading_class_label": t(rng.integers(0, 12, b).astype(np.int32)),
              "heading_residuals_label": t(rng.uniform(-0.25, 0.25, b).astype(np.float32)),
              "size_class_label": t(rng.integers(0, 3, b).astype(np.int32)),
              "size_residuals_label": t(rng.normal(0, 0.3, (b, 3)).astype(np.float32))}
    draws = {"noise": t(rng.random((b, n), dtype=np.float32)),
             "keep": t(rng.random((b, n, 128)) >= 0.5)}
    return inputs, labels, draws


def labeler_dp_check(mesh, inputs, labels, draws) -> dict:
    """(c), on each rank: the static labeler's data-parallel step (fresh from seed 0)
    against its single-process step on the same card and sets, with the noise floor of
    phase 8 measured on the card (a permutation of the sets and two mirrored pairs of
    rounding-level weight changes; a term that moves a seg decision is dropped). Sets
    whose seg mask differs between the two steps must differ only at knife-edge points
    (|logit margin| under ``SEG_KNIFE_EDGE``); they are taken out (with one more where
    the count left is odd, so that the sets still split over the ranks). Both controls
    must fail. Then the sharded eval step (K1/K2 on each rank's rows) must give the
    single-process eval's loss terms and metrics within 1e-5 of max(1, |x|). Rank 0
    returns the readings, every rank its state after the step and its K1/K2 launches
    in the sharded eval."""
    import torch.distributed as dist

    from tdal_torch.ops import fused_pointnet as fp
    from tdal_torch.parallel.controls import CONTROLS, control
    from tdal_torch.parallel.mesh import rank_rows, shard_batch
    from tdal_torch.pipeline.factories import make_labeler
    from tdal_torch.pipeline.labeler_engine import make_steps
    from tdal_torch.runtime.train_state import TrainState

    dev = mesh.device
    model, loss_fn, inputs_fn, _ = make_labeler("one_box_est", device=dev, seed=0)
    knife_sets = 0
    for _ in range(3):
        single = labeler_step(model, loss_fn, inputs, labels, draws, dev)
        dp = labeler_step(model, loss_fn, inputs, labels, draws, dev, mesh=mesh)
        mine, lg = rank_rows(single[3], mesh), rank_rows(single[4], mesh)
        differ = (dp[3] != mine).any(dim=1)
        margin = (lg[..., 1] - lg[..., 0]).abs()
        edge = SEG_KNIFE_EDGE * max(1.0, float(single[4].abs().max()))
        beyond = bool((margin[dp[3] != mine] > edge).any())
        flags = torch.zeros(len(inputs[0]) + 1, device=dev)  # the sets that differ, and
        flags[rank_rows(torch.arange(len(inputs[0])), mesh).to(dev)] = differ.float().to(dev)
        flags[-1] = float(beyond)  # a difference away from a knife edge, on any rank
        dist.all_reduce(flags, group=mesh.group)
        if flags[-1] > 0:
            raise AssertionError("(c): a seg mask differs between the data-parallel and "
                                 "the single-process step away from a knife edge")
        differ = (flags[:-1] > 0).cpu()
        if not differ.any():
            break
        knife_sets += int(differ.sum())
        keep = torch.nonzero(~differ).flatten()
        keep = keep[: len(keep) - len(keep) % mesh.world]
        inputs, labels, draws = _subset(inputs, labels, draws, keep)
    else:
        raise AssertionError(f"(c): seg masks still differ after {knife_sets} knife-edge sets")
    if len(inputs[0]) < DP_LABELER_SETS // 2:
        raise AssertionError(f"(c): {knife_sets} of {DP_LABELER_SETS} sets on knife edges")
    controls = {}
    for name in CONTROLS:
        with control(name):
            controls[name] = labeler_step(model, loss_fn, inputs, labels, draws, dev,
                                          mesh=mesh)
    _, eval_step = make_steps(model, loss_fn, inputs_fn)
    batch = dict(zip(("pts", "init_box", "bbox_gt"), inputs), **labels)
    state = TrainState(model, None)
    eval_single = {k: float(v) for k, v in eval_step(state, batch)[0].items()}
    for k in fp.launches:
        fp.launches[k] = 0
    with mesh:
        eval_dp = {k: float(v) for k, v in eval_step(state, shard_batch(batch, mesh))[0].items()}
    out = {"state": dp[2], "eval_launches": dict(fp.launches)}
    if mesh.rank != 0:
        return out
    perm = torch.arange(len(inputs[0])).roll(1)
    p_inputs, p_labels, p_draws = _subset(inputs, labels, draws, perm)
    steps = [("permutation", labeler_step(model, loss_fn, p_inputs, p_labels, p_draws, dev),
              perm)]
    for sign, s in PERTURBATIONS:
        steps.append((f"{'+' if sign > 0 else '-'}2^-19 weights, draw {s}", labeler_step(
            model, loss_fn, inputs, labels, draws, dev, perturb=sign * ULP_PERTURBATION,
            perturb_seed=s), None))
    noise, dropped = [], []
    for term, res, order in steps:
        mask = res[3] if order is None else res[3][torch.argsort(order)]
        (noise if torch.equal(mask, single[3]) else dropped).append((term, res[1]))
    if not noise:
        raise AssertionError("(c): every noise term moved a seg decision")
    sound, failures = compare_labeler_steps(model, single, dp, noise)
    eval_err = max(abs(eval_dp[k] - v) / max(1.0, abs(v)) for k, v in eval_single.items())
    if not eval_err <= 1e-5:
        failures.append(f"the sharded eval's metrics differ by {eval_err:.3e} of max(1, |x|)")
    readings = {"sound": sound}
    for name, step in controls.items():
        readings[name], fails = compare_labeler_steps(model, single, step, noise)
        if not fails:
            failures.append(f"the control ({name}) passes the comparison")
    out.update(readings=readings, failures=failures, knife_edge_sets=knife_sets,
               eval_rel_err=eval_err, eval_metrics=eval_dp,
               sets=len(inputs[0]), noise_terms=[t for t, _ in noise],
               dropped_noise_terms=[t for t, _ in dropped])
    return out


def dp_train_timing(mesh, pp_state, root: Path) -> dict:
    """``train_detector`` with ``mesh`` from ``pp_state``: a warm epoch, then
    ``PP_TIMED_EPOCHS`` epochs with the conv launch counters from 0 (each rank's steps
    must launch phase 6's per-step counts), synchronised; training frames/s of the
    global batch ``PP_BATCH``. Also the host seconds to build a global batch and one
    rank's share of it (every rank builds the whole batch and keeps its rows), and the
    scaling reading: ``DP_TIMED_STEPS`` train steps at ``DP_PER_CARD`` frames a rank,
    their batches built ahead on a thread as ``train_detector`` builds them, no
    checkpoint written."""
    from tdal_torch.data.detection import collate_detection
    from tdal_torch.ops import conv3x3 as cv
    from tdal_torch.parallel.mesh import rank_step
    from tdal_torch.pipeline.detector_engine import make_detector_steps
    from tdal_torch.pipeline.detector_run import _prefetch, train_detector

    cfg, model, state, ds, _ = pp_training(root)
    model.load_state_dict(pp_state)
    head = cfg.model["bbox_head"]
    logger = logging.getLogger("chip_smoke")

    def run(tag, epochs):
        train_detector(state, ds, head["code_weights"], n_epoch=epochs, batch_size=PP_BATCH,
                       logger=logger, work_dir=root / tag, weight=head["weight"],
                       log_every=1, mesh=mesh)
        torch.cuda.synchronize()

    run("warm", PP_WARM_EPOCHS)
    for k in cv.launches:
        cv.launches[k] = 0
    t0 = time.perf_counter()
    run("timed", PP_TIMED_EPOCHS)
    timed_s = time.perf_counter() - t0
    launches = dict(cv.launches)
    for name, n in launches.items():
        if n != PP_TIMED * PP_LAUNCHES[name]:
            raise AssertionError(f"rank {mesh.rank}: {name} launched {n} times in {PP_TIMED} "
                                 f"steps, expected {PP_LAUNCHES[name]} per step")
    build = {}
    for rows in (PP_BATCH, PP_BATCH // DP_WORLD):
        times = []
        for _ in range(3):
            t1 = time.perf_counter()
            collate_detection([ds[i] for i in range(rows)])
            times.append(time.perf_counter() - t1)
        build[rows] = statistics.median(times)
    global_batch = DP_PER_CARD * mesh.world

    def batches():  # epochs of the training set, each shuffled from its own seed
        for epoch in itertools.count():
            idx = np.random.default_rng(epoch).permutation(len(ds))
            for start in range(0, len(ds) - global_batch + 1, global_batch):
                yield collate_detection([ds[int(i)] for i in idx[start:start + global_batch]])

    step = make_detector_steps(state.model, head["code_weights"], head["weight"])
    n = DP_WARM_STEPS + DP_TIMED_STEPS
    for i, batch in enumerate(_prefetch(itertools.islice(batches(), n))):
        if i == DP_WARM_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        with rank_step(mesh, batch) as rows:
            step(state, rows)
    torch.cuda.synchronize()
    steps_s = time.perf_counter() - t0
    return dict(world=mesh.world, backend=mesh.backend, timed_s=timed_s,
                frames_per_s=PP_TIMED * PP_BATCH / timed_s, launches=launches,
                host_build_s={str(k): v for k, v in build.items()},
                scaling=dict(global_batch=global_batch, steps=DP_TIMED_STEPS, seconds=steps_s,
                             frames_per_s=DP_TIMED_STEPS * global_batch / steps_s))


def _dp_rank(mesh, job_file, out_dir):
    """A spawned rank of phase 10: the PointPillars step of ``job_file``'s model and
    batch (sound, and under each control), then (c)'s labeler check and the
    ``train_detector`` timing where the job asks for them. Rank 0 saves its steps and
    readings, the others their states."""
    from tdal_torch.parallel.controls import control
    from tdal_torch.runtime.config import Config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    job = torch.load(job_file, weights_only=False)
    cfg = Config(job["cfg"])
    steps = {}
    with deterministic():
        for name in (None, *job["controls"]):
            with control(name):
                steps[name] = step_with_grads(job["model"], job["batch"], mesh.device, cfg,
                                              job["n_steps_total"], mesh=mesh)
    out = {"steps": steps} if mesh.rank == 0 else {"state": steps[None][2]}
    if job["labeler"] is not None:
        out["labeler"] = labeler_dp_check(mesh, *job["labeler"])
    if job["train"]:
        out["train"] = dp_train_timing(mesh, job["pp_state"], Path(out_dir) / f"rank{mesh.rank}")
    torch.save(out, Path(out_dir) / f"{mesh.rank}.pt")


def share_line(readings: dict) -> str:
    """Each reading of ``compare_steps`` as a share of its tolerance."""
    return (f"loss {readings['loss_rel_err'] / 1e-4:.4g}, gradients "
            f"{readings['grad_err_over_tol']:.4g}, parameters after the update "
            f"{readings['param_err_over_allowed']:.4g}, running statistics "
            f"{readings['stat_rel_err'] / 1e-4:.4g} (relative bound) and "
            f"{readings['stat_err_over_tol']:.4g} (noise floor)")


def check_dp_steps(model, batch, cfg, n_steps_total, device, devices, backend, root: Path,
                   controls=None, labeler=None, pp_state=None) -> dict:
    """The PointPillars train step of ``model`` (on the CPU) on ``batch`` in
    ``len(devices)`` spawned ranks over ``backend`` against the single-process step on
    ``device``, held by ``compare_steps`` with phase 6's noise floor measured on the
    card (the single-process step under a permutation of the batch and two mirrored
    pairs of rounding-level weight changes; ``GRAD_NOISE_MARGIN`` times it). Every rank
    must end with the same state, and each control (default: every one of
    ``tdal_torch.parallel.controls.CONTROLS``) must fail on its gradients. With
    ``labeler``, (c)'s check runs in the same ranks; with ``pp_state``, the ranks also
    time ``train_detector`` from those weights."""
    from tdal_torch.parallel.controls import CONTROLS
    from tdal_torch.parallel.mesh import spawn

    controls = CONTROLS if controls is None else controls
    t0 = time.perf_counter()
    with deterministic():  # as the ranks' steps
        single = step_with_grads(model, batch, device, cfg, n_steps_total)
        noise = noise_steps_of(model, batch, device, cfg, n_steps_total)
    noise_grads, noise_states = [n[1] for n in noise], [n[2] for n in noise]
    del noise
    torch.cuda.empty_cache()
    t_single = time.perf_counter() - t0
    job = root / "dp_job.pt"
    torch.save(dict(model=model, batch=batch, cfg=cfg.to_dict(), n_steps_total=n_steps_total,
                    controls=controls, labeler=labeler, pp_state=pp_state,
                    train=pp_state is not None), job)
    t0 = time.perf_counter()
    spawn(_dp_rank, (str(job), str(root)), devices=devices, backend=backend)
    t_ranks = time.perf_counter() - t0
    ranks = [torch.load(root / f"{r}.pt", weights_only=False) for r in range(len(devices))]
    steps = ranks[0]["steps"]
    reference = (single[0], single[1], single[2], single[4])
    as_card = lambda s: (s[0], s[1], s[2], s[4])  # noqa: E731
    worst, failures, leaves = compare_steps(model, as_card(steps[None]), reference, noise_grads,
                                            single[3], noise_states)
    for other in ranks[1:]:
        unequal = [k for k, v in steps[None][2].items() if not torch.equal(v, other["state"][k])]
        if unequal:
            failures.append(f"the ranks' states differ after the step: {unequal[:3]}")
    readings = {"sound": worst}
    log(f"  PointPillars, global batch {len(batch['points'])} on {len(devices)} ranks "
        f"({backend}, {', '.join(devices)}) against one process on {device}: loss "
        f"{steps[None][0]:.6f} / {single[0]:.6f}; {share_line(worst)}; single-process "
        f"step and its {len(NOISE_TERMS)} noise steps {t_single:.1f} s, the ranks "
        f"(spawn, build, steps) {t_ranks:.1f} s")
    for ratio, k, err, scale, nz in sorted(leaves, reverse=True)[:3]:
        log(f"    gradient {k}: error {err:.3e} = {ratio:.3f} of tolerance; largest "
            f"gradient {scale:.3e}, noise floor {nz:.3e}")
    for name in controls:
        readings[name], c_fail, _ = compare_steps(model, as_card(steps[name]), reference,
                                                  noise_grads, single[3], noise_states)
        log(f"  control ({name}): {len(c_fail)} failures; {share_line(readings[name])}")
        if not readings[name]["grad_err_over_tol"] > 1:
            failures.append(f"control {name}: its gradients pass the comparison")
    out = dict(readings=readings, loss_dp=steps[None][0], loss_single=single[0],
               single_s=t_single, ranks_s=t_ranks, devices=devices, backend=backend,
               # for phase 14 (b): the same step, floor and batch (popped before printing)
               reference=dict(single=single, noise_grads=noise_grads,
                              noise_states=noise_states, batch=batch,
                              n_steps_total=n_steps_total))
    if labeler is not None:
        lab = ranks[0]["labeler"]
        failures += [f"(c) {f}" for f in lab["failures"]]
        for other in ranks[1:]:
            if any(not torch.equal(v, other["labeler"]["state"][k])
                   for k, v in lab["state"].items()):
                failures.append("(c): the ranks' states differ after the step")
        log(f"  (c) the static labeler, {lab['sets']} sets at production widths on "
            f"{len(devices)} ranks against one process ({lab['knife_edge_sets']} knife-edge "
            f"sets taken out; noise terms {lab['noise_terms']}, dropped "
            f"{lab['dropped_noise_terms']}):")
        for name, r in lab["readings"].items():
            log(f"    {name}: loss {r['loss_rel_err'] / 1e-4:.4g}, gradients "
                f"{r['grad_err_over_tol']:.4g}, parameters {r['param_err_over_allowed']:.4g}, "
                f"running statistics {r['stat_rel_err'] / STAT_TOL:.4g} of their tolerance")
        eval_launches = {k: sum(r["labeler"]["eval_launches"][k] for r in ranks)
                         for k in lab["eval_launches"]}
        log(f"    the sharded eval against one process: {lab['eval_rel_err'] / 1e-5:.4g} of its "
            f"tolerance; K1/K2 launches on the {len(devices)} ranks {eval_launches}")
        per_rank = int(torch.device(devices[0]).type == "cuda")  # the CPU runs the twins
        if any(r["labeler"]["eval_launches"] != {k: per_rank for k in eval_launches}
               for r in ranks):
            failures.append(f"(c): the sharded eval's K1/K2 launches {eval_launches}, "
                            f"{per_rank} each a rank expected")
        out["labeler"] = {k: v for k, v in lab.items() if k != "state"}
        out["labeler"]["eval_launches"] = eval_launches
    if pp_state is not None:
        out["train"] = [r["train"] for r in ranks]
    if failures:
        raise AssertionError("phase 10: " + "; ".join(failures[:10]))
    return out


def dp_world_one(device, pp_state, root: Path) -> dict:
    """(b): ``train_detector`` as one rank of a process group over NCCL."""
    import torch.distributed as dist

    from tdal_torch.parallel.mesh import free_port, make_mesh

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        return dp_train_timing(make_mesh(torch.device("cuda", torch.cuda.current_device())),
                               pp_state, root)
    finally:
        dist.destroy_process_group()


def phase_data_parallel(device, pp_state, phase6_fps=None) -> dict:
    """Phase 10: (a) two gloo ranks on one card against one process, with two controls,
    and (c) the static labeler likewise, in the same ranks; (b) ``train_detector`` as
    one NCCL rank beside phase 6's frames/s; (d) on two cards over NCCL where there are
    two."""
    from tdal_torch.data.detection import collate_detection

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        cfg, model, _, ds, total_steps = pp_training(root / "a")
        model = model.cpu()
        model.load_state_dict(pp_state)
        batch = first_frames(collate_detection([ds[i] for i in range(PP_BATCH)]), PP_BATCH)
        log("  (a) PointPillars on two gloo ranks on one card, and (c) the static labeler")
        (root / "ranks_a").mkdir()
        out["a"] = check_dp_steps(model, batch, cfg, total_steps, device, ["cuda:0"] * DP_WORLD,
                                  "gloo", root / "ranks_a", labeler=dp_labeler_inputs())
        out["c"] = out["a"].pop("labeler")
        seconds = [time.perf_counter() - t0]
        log("  (b) train_detector as one rank over NCCL")
        b = dp_world_one(device, pp_state, root / "b")
        gap = (b["host_build_s"][str(PP_BATCH)] - b["host_build_s"][str(PP_BATCH // DP_WORLD)])
        log(f"    {b['frames_per_s']:.2f} training frames/s at world size 1 ({PP_TIMED} steps "
            f"in {b['timed_s']:.3f} s) against phase 6's "
            + (f"{phase6_fps:.2f}" if phase6_fps else "(not run)") + " without "
            f"a process group; launches {b['launches']}; host: a global batch of {PP_BATCH} "
            f"builds in {b['host_build_s'][str(PP_BATCH)]:.3f} s, a rank's {PP_BATCH // DP_WORLD} "
            f"rows of it in {b['host_build_s'][str(PP_BATCH // DP_WORLD)]:.3f} s: building the "
            f"whole batch on every rank adds {gap:.3f} s a step at world size {DP_WORLD} "
            f"(on the prefetch thread, behind the step)")
        sc = b["scaling"]
        log(f"    scaling reading at world size 1: {sc['steps']} train steps at "
            f"{DP_PER_CARD} frames a card in {sc['seconds']:.3f} s, "
            f"{sc['frames_per_s']:.2f} training frames/s (no checkpoint writes)")
        out["b"] = dict(b, phase6_frames_per_s=phase6_fps, added_host_s=gap)
        seconds.append(time.perf_counter() - t0 - sum(seconds))
        if torch.cuda.device_count() >= 2:
            log("  (d) PointPillars on two cards over NCCL")
            (root / "ranks_d").mkdir()
            d = check_dp_steps(model, batch, cfg, total_steps, device, ["cuda:0", "cuda:1"],
                               "nccl", root / "ranks_d", controls=(), pp_state=pp_state)
            fps = d["train"][0]["frames_per_s"]
            log(f"    train_detector at a global batch of {PP_BATCH} ({PP_TIMED} steps, "
                f"checkpoint writes included; a smoke figure): {fps:.2f} training frames/s "
                f"on 2 cards against {b['frames_per_s']:.2f} on one rank: "
                f"{fps / b['frames_per_s']:.2f}x")
            sd = d["train"][0]["scaling"]
            log(f"    scaling: {sd['steps']} train steps at {DP_PER_CARD} frames a card "
                f"(global batch {sd['global_batch']}) in {sd['seconds']:.3f} s, "
                f"{sd['frames_per_s']:.2f} training frames/s on 2 cards against "
                f"{sc['frames_per_s']:.2f} on one: {sd['frames_per_s'] / sc['frames_per_s']:.3f}x "
                f"(2.000x would be linear)")
            out["d"] = d
        else:
            log("  one card: (d) not run")
            out["d"] = "one card: not run"
        seconds.append(time.perf_counter() - t0 - sum(seconds))
    log(f"  phase 10 seconds: (a) + (c) {seconds[0]:.1f}, (b) {seconds[1]:.1f}, (d) "
        f"{seconds[2]:.1f}")
    out["seconds"] = seconds
    return out


# ---------------------------------------------------------------------------
# phase 11: the port's data preparation and GT-aug training on the Waymo PP config
# ---------------------------------------------------------------------------

# a training segment in the decoded per-frame layout: 2 scenes of 8 frames, 6 static and
# 2 dynamic vehicles a scene (the config samples up to VEHICLE=15 a frame, so each frame
# has a deficit to fill; the other scene's objects give candidates clear of this one's)
PREP_SCENES = dict(n_frames=8, seed=0, n_static=6, n_dynamic=2, points_per_object=256,
                   n_background=150000)
PREP_N_SCENES = 2
PREP_TIMED_EPOCHS = 1
PREP_FRAMES = PREP_N_SCENES * PREP_SCENES["n_frames"]
PREP_TIMED = PREP_TIMED_EPOCHS * PREP_FRAMES // PP_BATCH  # steps
PREP_INFOS = "infos_train_01sweeps_filter_zero_gt.pkl"
# tdal's name for the database of one sweep ({nsweeps}, not the config's {:02d})
PREP_DBINFOS = "dbinfos_train_1sweeps_withvelo.pkl"


def pasted_collisions(frame_boxes, pasted) -> int:
    """Pasted boxes of a frame that collide in BEV with any other box of the frame (its
    own boxes, then the pasted ones)."""
    from tdal_torch.data.gt_augment import box_collision_test

    n, k = len(pasted), len(frame_boxes)
    hit = box_collision_test(pasted, np.concatenate([frame_boxes, pasted]))
    hit[np.arange(n), k + np.arange(n)] = False  # a box against itself
    return int(hit.any(axis=1).sum())


def phase_data_prep(device, pp_state=None) -> dict:
    """Phase 11: a Waymo-layout training segment through the port's ``create_data
    waymo_data_prep`` (a subprocess, the CLI's entry point), then ``train_detector`` of
    the Waymo PP config at full width with its GT-aug sampler enabled on that database
    (the training set built by ``tdal_torch.tools.train.build_train_dataset``, the CLI's
    own function), from ``pp_state`` or fresh from seed 0: a warm epoch, then
    ``PREP_TIMED_EPOCHS`` timed with the conv launch counters from 0. Every pasted box
    is recorded with its frame's boxes."""
    from tdal_torch.data.detection import collate_detection
    from tdal_torch.data.synthetic import SyntheticScene
    from tdal_torch.data.waymo_schema import load_pickle
    from tdal_torch.models.builder import build_assigner, build_detector, build_voxel_config
    from tdal_torch.ops import conv3x3 as cv
    from tdal_torch.runtime.config import Config
    from tdal_torch.runtime.schedules import adam_with_schedule, one_cycle
    from tdal_torch.runtime.train_state import TrainState
    from tdal_torch.tools.train import build_train_dataset

    logger = logging.getLogger("chip_smoke")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        for i in range(PREP_N_SCENES):
            SyntheticScene(i, **PREP_SCENES).write(root, split="train")
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "tdal_torch.tools.create_data",
                              "waymo_data_prep", "--root_path", str(root)],
                             cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                             timeout=600)
        prep_s = time.perf_counter() - t0
        if run.returncode != 0:
            raise AssertionError(f"create_data waymo_data_prep exited with {run.returncode}:\n"
                                 f"{run.stdout[-2000:]}{run.stderr[-4000:]}")
        infos = load_pickle(root / PREP_INFOS)
        dbinfos = load_pickle(root / PREP_DBINFOS)
        crops = {str(k): len(v) for k, v in dbinfos.items()}
        bins = {d.name: len(list(d.glob("*.bin")))
                for d in (root / "gt_database_1sweeps_withvelo").iterdir()}
        log(f"  {PREP_N_SCENES} scenes of {PREP_SCENES['n_frames']} frames written in "
            f"{write_s:.1f} s; create_data waymo_data_prep (a subprocess) {prep_s:.1f} s: "
            f"{len(infos)} infos, crops by class {crops}, .bin files {bins}")
        if len(infos) != PREP_FRAMES or not crops or crops != bins:
            raise AssertionError(f"create_data: {len(infos)} infos ({PREP_FRAMES} expected), "
                                 f"dbinfos {crops}, .bin files {bins}")

        cfg = Config.fromfile(PP_CONFIG)
        db = cfg.train_preprocessor.db_sampler
        db.enable, db.db_info_path = True, str(root / PREP_DBINFOS)
        voxel_cfg = build_voxel_config(cfg.voxel_generator, train=True)
        model = build_detector(cfg.model, voxel_cfg, seed=0)
        if pp_state is not None:
            model.load_state_dict(pp_state)
        assigner = build_assigner(cfg.train_cfg["assigner"], model)
        ds = build_train_dataset(cfg, infos, assigner, voxel_cfg, seed=0, logger=logger)
        if ds.db_sampler is None:
            raise AssertionError("the GT-aug sampler is off: the phase would train without it")
        sampler, draws = ds.db_sampler, []
        sample_all = sampler.sample_all

        def recorded(gt_boxes, gt_names, rng):
            out = sample_all(gt_boxes, gt_names, rng)
            draws.append((gt_boxes.copy(), None if out is None else out["gt_boxes"],
                          0 if out is None else len(out["points"])))
            return out

        sampler.sample_all = recorded
        total_steps = PREP_FRAMES // PP_BATCH * cfg.total_epochs
        lr, mom = one_cycle(cfg.lr_config["lr_max"], total_steps, tuple(cfg.lr_config["moms"]),
                            cfg.lr_config["div_factor"], cfg.lr_config["pct_start"])
        state = TrainState(model, adam_with_schedule(model.parameters(), lr, cfg.optimizer["wd"],
                                                     cfg.grad_clip["max_norm"], mom))
        warm_s, warm_rows = train_epochs(state, ds, cfg, root / "warm", 1)
        torch.cuda.reset_peak_memory_stats()
        for k in cv.launches:
            cv.launches[k] = 0
        timed_s, rows = train_epochs(state, ds, cfg, root / "timed", PREP_TIMED_EPOCHS)
        launches = dict(cv.launches)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        sampler.sample_all = sample_all

        # the host's share: one batch of 4 built with the sampler and without it
        host = {}
        for tag, db_sampler in (("with the sampler", sampler), ("without", None)):
            ds.db_sampler, times = db_sampler, []
            for _ in range(3):
                t0 = time.perf_counter()
                collate_detection([ds[i] for i in range(PP_BATCH)])
                times.append(time.perf_counter() - t0)
            host[tag] = statistics.median(times)
        ds.db_sampler = sampler

    boxes = [0 if b is None else len(b) for _, b, _ in draws]
    points = [n for _, _, n in draws]
    collisions = sum(pasted_collisions(f, b) for f, b, _ in draws if b is not None)
    losses = [r["loss"] for r in warm_rows + rows]
    per_step = {k: v / PREP_TIMED for k, v in launches.items()}
    frames_per_s = PREP_TIMED * PP_BATCH / timed_s
    log(f"  GT-aug over {len(draws)} training frames: pasted boxes a frame mean "
        f"{np.mean(boxes):.3f}, min {min(boxes)}, max {max(boxes)}; pasted points a frame "
        f"mean {np.mean(points):.1f}, min {min(points)}, max {max(points)}; {collisions} "
        f"pasted boxes collide with another box of their frame")
    log(f"  host: a batch of {PP_BATCH} built in {host['with the sampler']:.3f} s with the "
        f"sampler, {host['without']:.3f} s without (median of 3; the prefetch thread builds "
        f"it behind a step)")
    log(f"  train_detector with GT-aug: {PREP_TIMED} timed steps in {timed_s:.3f} s "
        f"({frames_per_s:.2f} training frames/s, a checkpoint included), warm epoch "
        f"{warm_s:.1f} s; peak memory {peak_gib:.2f} GiB; losses {losses}; launches a step "
        f"{per_step}")
    if not np.mean(boxes) >= 1:
        raise AssertionError(f"GT-aug pasted {np.mean(boxes):.3f} boxes a frame, fewer than 1")
    if collisions:
        raise AssertionError(f"{collisions} pasted boxes collide with another box of their frame")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"a non-finite loss: {losses}")
    if len(rows) != PREP_TIMED:
        raise AssertionError(f"{len(rows)} timed steps logged, expected {PREP_TIMED}")
    for name, n in launches.items():
        if n != PREP_TIMED * PP_LAUNCHES[name]:
            raise AssertionError(f"{name}: {n} launches in {PREP_TIMED} steps, expected "
                                 f"{PP_LAUNCHES[name]} per step")
    return dict(prep_s=prep_s, write_s=write_s, infos=len(infos), crops=crops,
                pasted_boxes=dict(mean=float(np.mean(boxes)), min=min(boxes), max=max(boxes)),
                pasted_points=dict(mean=float(np.mean(points)), min=min(points),
                                   max=max(points)),
                collisions=collisions, host_batch_s=host, timed_s=timed_s,
                frames_per_s=frames_per_s, warm_s=warm_s, peak_gib=peak_gib, losses=losses,
                launches=launches)


# ---------------------------------------------------------------------------
# phase 12: the deformable head on the two-sweep velocity VoxelNet
# ---------------------------------------------------------------------------

DCN_CONFIG = Path("configs/waymo/voxelnet/waymo_centerpoint_voxelnet_two_sweeps_3x_with_velo.py")
# 9 frames of phase 9's slab: frame f >= 1 is a training frame, frame f - 1 its previous
# sweep (0.1 s earlier; the ego has moved 0.5 m and the dynamic objects 0.3-0.8 m)
DCN_DATA = dict(VN_DATA, n_frames=9)
DCN_TEST_DATA = dict(DCN_DATA, seed=1)
DCN_TIME_LAG = 0.1
DCN_BATCH, DCN_TIMED_EPOCHS = 4, 1
DCN_TIMED = DCN_TIMED_EPOCHS * (DCN_DATA["n_frames"] - 1) // DCN_BATCH  # steps
DCN_CHECK_BATCH = 2
# the 13 stride-1 3x3 sites of the step: the RPN's 11 (phase 9's), the head's shared
# conv and the regression SepHead's fused first conv. 9 are chained (K7): the RPN's;
# the shared conv's output is materialised for the deformable sampling, so the SepHead
# conv takes no input affine, and neither does the shared conv (K4 at both)
DCN_SITES, DCN_CHAINED = 13, 9
DCN_LAUNCHES = {"conv3x3_fwd_stats": DCN_SITES, "conv3x3_fwd": DCN_SITES - DCN_CHAINED,
                "conv3x3_dgrad_act": DCN_CHAINED, "conv3x3_wgrad": DCN_SITES}
KNIFE_EDGE = 1e-6  # a sampling coordinate this close to an integer is counted


def dcn_model_cfg(cfg, dtype=None) -> dict:
    """The config's model with ``bbox_head.dcn_head`` on (and ``dtype`` where given)."""
    model = dict(cfg.model, bbox_head=dict(cfg.model["bbox_head"], dcn_head=True))
    return model if dtype is None else dict(model, dtype=dtype)


def two_sweep_infos(root: Path, data: dict) -> list:
    """A synthetic segment of ``data``'s frames under ``root``: the infos of every frame
    but the first, each with the frame before it as its one previous sweep (its
    ``transform_matrix`` maps that frame's vehicle frame into this one's)."""
    from tdal_torch.data.synthetic import make_synthetic_dataset

    infos, scenes = make_synthetic_dataset(root, **data)
    poses = scenes[0].ego_poses
    return [dict(infos[f], sweeps=[dict(path=infos[f - 1]["path"], time_lag=DCN_TIME_LAG,
                                        transform_matrix=np.linalg.inv(poses[f]) @ poses[f - 1])])
            for f in range(1, len(infos))]


@contextlib.contextmanager
def trunc_sampling():
    """A wrong sampler for a control: ``deform_sample`` splits each coordinate with
    ``trunc`` in place of ``floor`` (they differ for every negative coordinate)."""
    from tdal_torch.models import dcn

    original = dcn._cell
    dcn._cell = torch.trunc
    try:
        yield
    finally:
        dcn._cell = original


def sampling_coordinates_of(model, points) -> list:
    """The sampling coordinates (ys, xs stacked) of each deformable conv of ``model`` in
    a train-mode forward of a copy on ``points``' device."""
    from tdal_torch.models.dcn import DeformConv, sampling_coordinates

    m = copy.deepcopy(model).train()
    coords = []
    hooks = [d.register_forward_hook(lambda mod, args, out: coords.append(torch.stack(
        sampling_coordinates(args[1], mod.kernel_size)).cpu()))
        for d in m.modules() if isinstance(d, DeformConv)]
    with torch.no_grad():
        m(points)
    for h in hooks:
        h.remove()
    return coords


def knife_edges(model, points, device) -> dict:
    """For each deformable conv, on the card and on a CPU copy: the sampling coordinates
    within ``KNIFE_EDGE`` of an integer, and those whose floor differs between the two
    (the corners they interpolate differ, and so do their one-sided offset gradients)."""
    card = sampling_coordinates_of(copy.deepcopy(model).to(device), points.to(device))
    cpu = sampling_coordinates_of(model.cpu(), points.cpu())
    out = []
    for c, p in zip(card, cpu):
        out.append(dict(coordinates=c.numel(),
                        near_card=int(((c - c.round()).abs() < KNIFE_EDGE).sum()),
                        near_cpu=int(((p - p.round()).abs() < KNIFE_EDGE).sum()),
                        floors_differ=int((c.floor() != p.floor()).sum()),
                        largest_offset=float((p - p.round()).abs().max())))
    return dict(zip(("center_adapt", "reg_adapt"), out))


def dcn_head_alone(model, batch, device, code_weights) -> dict:
    """The deformable head's forward + backward alone (train mode, its loss), on the RPN
    output of ``batch``: median ms of 3 after a warm call, and its peak memory above
    what was held before it; the head's running statistics restored after."""
    from tdal_torch.models.center_head import center_head_loss
    from tdal_torch.pipeline.detector_engine import TARGET_KEYS, batch_to_device

    head, saved = model.head, copy.deepcopy(model.head.state_dict())
    b = batch_to_device(batch, device)
    feats = {}
    hook = head.register_forward_pre_hook(lambda mod, args: feats.__setitem__("x", args[0]))
    model.train()
    with torch.no_grad():
        model(b["points"])
    hook.remove()
    x = feats["x"].detach()
    times = []
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(4):
        t0 = time.perf_counter()
        preds = head(x)
        total, _ = center_head_loss(preds, {k: b[k] for k in TARGET_KEYS},
                                    code_weights, 2.0, has_vel=True)
        total.backward()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - base
    model.zero_grad(set_to_none=True)
    head.load_state_dict(saved)
    return dict(ms=1e3 * statistics.median(times[1:]), peak_gib=peak / 2**30,
                input_shape=list(x.shape), input_dtype=str(x.dtype))


def phase_dcn(device) -> dict:
    """Phase 12: the two-sweep velocity VoxelNet config with ``dcn_head`` at full width,
    bf16 as the config declares. (a) ``train_detector`` at batch 4: a warm epoch under
    ``deterministic`` (its end is the check's snapshot), then ``DCN_TIMED`` steps with the
    conv launch counters from 0; the step alone, the head alone, peak memory. (b) One
    step at batch 2 of the snapshot in f32 on the card against a CPU copy, under
    ``deterministic``, as phase 9 (a) holds its own; a sampler with ``trunc`` in place
    of ``floor`` must fail it; the sampling coordinates on a knife edge counted.
    (c) ``run_inference`` at the config's test settings over 8 frames, and one frame in
    f32 against a CPU copy. (b)'s CPU copy runs in the CPU lane: ``out["check"]``
    holds its ``PendingCheck`` under ``pending``."""
    from tdal_torch.data.detection import DetectionDataset, collate_detection
    from tdal_torch.models.builder import (
        build_assigner, build_detector, build_test_cfg, build_voxel_config,
    )
    from tdal_torch.models.center_head import predict
    from tdal_torch.ops import conv3x3 as cv
    from tdal_torch.pipeline.detector_engine import make_detector_steps
    from tdal_torch.pipeline.detector_run import run_inference, train_detector
    from tdal_torch.runtime.config import Config
    from tdal_torch.runtime.schedules import adam_with_schedule, one_cycle
    from tdal_torch.runtime.train_state import TrainState, param_count

    logger = logging.getLogger("chip_smoke")
    peaks = []

    def reset_peak():
        """Keep the peak so far (the phase's is the largest), then start a new one."""
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    torch.cuda.reset_peak_memory_stats()
    cfg = Config.fromfile(DCN_CONFIG)
    head_cfg = cfg.model["bbox_head"]
    model_cfg = dcn_model_cfg(cfg)
    voxel_cfg = build_voxel_config(cfg.voxel_generator, train=True)
    model = build_detector(model_cfg, voxel_cfg, seed=0)
    pre = cfg.train_preprocessor
    n_frames = DCN_DATA["n_frames"] - 1
    total_steps = n_frames // DCN_BATCH * cfg.total_epochs
    lr, mom = one_cycle(cfg.lr_config["lr_max"], total_steps, tuple(cfg.lr_config["moms"]),
                        cfg.lr_config["div_factor"], cfg.lr_config["pct_start"])
    state = TrainState(model, adam_with_schedule(model.parameters(), lr, cfg.optimizer["wd"],
                                                 cfg.grad_clip["max_norm"], mom))
    log(f"  {DCN_CONFIG} with dcn_head: {param_count(model)} parameters, {cfg.model['dtype']}, "
        f"{cfg.nsweeps} sweeps, {cfg.model['reader']['num_input_features']} point "
        f"features, heads {list(model.head.tasks[0].reg.names) + ['hm']}, "
        f"{len(head_cfg['code_weights'])} code weights; batch {DCN_BATCH}")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        infos = two_sweep_infos(root / "data", DCN_DATA)
        ds = DetectionDataset(
            infos, cfg.class_names, build_assigner(cfg.assigner, model), voxel_cfg,
            mode="train", nsweeps=cfg.nsweeps, max_points=cfg.data["train"]["max_points"],
            global_rot_noise=tuple(pre["global_rot_noise"]),
            global_scale_noise=tuple(pre["global_scale_noise"]),
            shuffle_points=pre["shuffle_points"], seed=0)
        batch = collate_detection([ds[i] for i in range(DCN_BATCH)])
        pts = batch["points"]
        n_points = [int(np.isfinite(p[:, 0]).sum()) for p in pts]
        lags = sorted({float(v) for v in np.unique(pts[..., 5][np.isfinite(pts[..., 5])])})
        moving = [float(np.abs(a[m > 0][:, 6:8]).max()) for a, m in
                  zip(batch["anno_box"][0], batch["mask"][0])]
        log(f"  {len(ds)} two-sweep frames written in {time.perf_counter() - t0:.1f} s; points "
            f"per frame {n_points}, time lags {lags}; largest velocity target a frame "
            f"{[round(v, 3) for v in moving]} m/s")
        if lags != [0.0, float(np.float32(DCN_TIME_LAG))] or not min(moving) > 0:
            raise AssertionError(f"the frames lack their previous sweep or moving objects: "
                                 f"time lags {lags}, velocity targets {moving}")

        def run(tag, epochs):
            work = root / tag
            t0 = time.perf_counter()
            train_detector(state, ds, head_cfg["code_weights"], n_epoch=epochs,
                           batch_size=DCN_BATCH, logger=logger, work_dir=work,
                           weight=head_cfg["weight"], log_every=1)
            torch.cuda.synchronize()
            rows = [json.loads(line) for line in
                    (work / "logs" / "metrics.jsonl").read_text().splitlines()]
            return time.perf_counter() - t0, rows

        with deterministic() as named:
            warm_s, warm_rows = run("warm", 1)
        snapshot = copy.deepcopy(model).cpu()
        log(f"  warm epoch under deterministic algorithms in {warm_s:.1f} s (its end is the "
            f"check's snapshot); ops without a deterministic version: {named or 'none'}")
        reset_peak()
        for k in cv.launches:
            cv.launches[k] = 0
        s0 = sparse_launches()
        timed_s, rows = run("timed", DCN_TIMED_EPOCHS)
        launches = dict(cv.launches)
        sparse = sparse_launches() - s0
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        losses = [r["loss"] for r in warm_rows + rows]
        log(f"  losses {losses}")
        if not all(math.isfinite(v) for v in losses) or len(rows) != DCN_TIMED:
            raise AssertionError(f"non-finite or missing losses: {losses}")
        log(f"  conv kernel launches per step: { {k: v / DCN_TIMED for k, v in launches.items()} } "
            f"(expected {DCN_LAUNCHES}: {DCN_SITES} stride-1 3x3 sites, {DCN_CHAINED} chained)")
        for name, n in launches.items():
            if n != DCN_TIMED * DCN_LAUNCHES[name]:
                raise AssertionError(f"{name}: {n} launches in {DCN_TIMED} steps, expected "
                                     f"{DCN_LAUNCHES[name]} per step")
        expect_sparse_launches("phase 12 timed steps", sparse, VN_SPARSE_STEP, DCN_TIMED)
        step = make_detector_steps(model, head_cfg["code_weights"], head_cfg["weight"])
        step_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        step_ms = 1e3 * statistics.median(step_s)
        reset_peak()
        head = dcn_head_alone(model, batch, device, head_cfg["code_weights"])
        frames_per_s = DCN_TIMED * DCN_BATCH / timed_s
        log(f"  train_detector: {DCN_TIMED} steps in {timed_s:.3f} s (host data, logging and a "
            f"checkpoint included), {frames_per_s:.2f} training frames/s; step alone "
            f"{step_ms:.1f} ms (median of 3: {', '.join(f'{1e3 * v:.1f}' for v in step_s)}); "
            f"the deformable head alone, forward + backward on the RPN's "
            f"{head['input_shape']} {head['input_dtype']} output, {head['ms']:.1f} ms "
            f"({100 * head['ms'] / step_ms:.1f}% of the step), its peak {head['peak_gib']:.3f} "
            f"GiB above what was held; peak memory of the timed steps {peak_gib:.2f} GiB")
        out["train"] = dict(launches=launches, launches_per_step=DCN_LAUNCHES,
                            sparse_launches=sparse, losses=losses,
                            step_ms=step_ms, step_s=step_s, timed_s=timed_s,
                            frames_per_s=frames_per_s, peak_gib=peak_gib, head=head,
                            warm_s=warm_s, points_per_frame=n_points,
                            nondeterministic_ops=named)

        # (b) the snapshot's step in f32, card against a CPU copy
        f32 = build_detector(dcn_model_cfg(cfg, "float32"), voxel_cfg, device="cpu", seed=0)
        f32.load_state_dict(snapshot.state_dict())
        check_batch = first_frames(batch, DCN_CHECK_BATCH)
        edges = knife_edges(f32, torch.as_tensor(check_batch["points"]), device)
        log(f"  sampling coordinates within {KNIFE_EDGE:g} of an integer, card / CPU, and "
            f"coordinates whose floor differs: " + "; ".join(
                f"{k}: {v['near_card']} / {v['near_cpu']} of {v['coordinates']}, "
                f"{v['floors_differ']} differ" for k, v in edges.items()))
        with deterministic() as named_check:
            check = check_step_with_controls(
                f32, check_batch, device, cfg, total_steps,
                {"trunc in place of floor": (f32, trunc_sampling, "grad_err_over_tol")},
                stat_noise=True, name="phase 12 (b)'s card-vs-CPU step",
                deterministic_reference=True)
        log(f"  the check's card steps ran under deterministic algorithms; ops without a "
            f"deterministic version: {named_check or 'none'}; its CPU copy runs in the "
            f"CPU lane")
        out["check"] = dict(knife_edges=edges, check_batch=DCN_CHECK_BATCH,
                            nondeterministic_ops=named_check, pending=check)

        # (c) inference at the test settings, bf16; one frame in f32 against the CPU
        vox_test = build_voxel_config(cfg.voxel_generator, train=False)
        infer = build_detector(model_cfg, vox_test, device=device, seed=0)
        infer.load_state_dict(model.state_dict())
        test_cfg = build_test_cfg(cfg.test_cfg, infer, vox_test)
        test_infos = two_sweep_infos(root / "test", DCN_TEST_DATA)
        test_ds = DetectionDataset(test_infos, cfg.class_names,
                                   build_assigner(cfg.assigner, infer), vox_test, mode="test",
                                   nsweeps=cfg.nsweeps, max_points=cfg.data["val"]["max_points"])
        istate = TrainState(infer, None)
        run_inference(istate, test_ds, test_cfg, INFER_BATCH, logger)  # warm
        reset_peak()
        t0 = time.perf_counter()
        dets = run_inference(istate, test_ds, test_cfg, INFER_BATCH, logger)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        kept = [len(d["scores"]) for d in dets.values()]
        if len(dets) != len(test_ds) or not all(np.isfinite(d["box3d_lidar"]).all()
                                                and d["box3d_lidar"].shape[1] == 9
                                                for d in dets.values()):
            raise AssertionError("detections missing, not finite or not 9 wide")
        inf = dict(frames=len(test_ds), total_s=total, frames_per_s=len(test_ds) / total,
                   kept_per_frame=float(np.mean(kept)),
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        points = torch.as_tensor(np.stack([test_ds[i]["points"] for i in range(INFER_BATCH)]),
                                 device=device)
        fwd, post = [], []
        infer.eval()
        with torch.no_grad():
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                maps = infer(points)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                predict(maps, test_cfg, infer.num_classes)
                torch.cuda.synchronize()
                fwd.append(t1 - t0)
                post.append(time.perf_counter() - t1)
        inf["forward_ms_per_batch"] = 1e3 * statistics.median(fwd[1:])
        inf["nms_ms_per_frame"] = 1e3 * statistics.median(post[1:]) / INFER_BATCH
        log(f"  run_inference (bf16): {inf['frames_per_s']:.3f} frames/s over {len(test_ds)} "
            f"frames, host data included (after a warm pass); kept boxes per frame "
            f"{inf['kept_per_frame']:.1f}; peak memory {inf['peak_gib']:.2f} GiB; one batch of "
            f"{INFER_BATCH}: forward {inf['forward_ms_per_batch']:.1f} ms, decode + NMS "
            f"{inf['nms_ms_per_frame']:.1f} ms per frame (medians of 3)")
        del infer, istate, maps
        f32_infer = build_detector(dcn_model_cfg(cfg, "float32"), vox_test, device=device,
                                   seed=0)
        f32_infer.load_state_dict(model.state_dict())
        inf["cpu_check"] = check_infer_against_cpu(f32_infer, points[:1], test_cfg)
        out["infer"] = inf
    reset_peak()
    out["peak_gib"] = max(peaks) / 2**30
    return out


# a rounding-level relative change of every weight: the probe's stand-in for the
# card-vs-CPU rounding difference, which costs a minute and a half of CPU to measure
PROBE_ROUNDING = 2.0**-22
PROBE_FLOORS = {"one-sided": NOISE_TERMS[:2], "one mirrored pair": NOISE_TERMS[:3],
                "two mirrored pairs (phase 6)": NOISE_TERMS}


def noise_probe(device, n_states: int) -> dict:
    """On the card alone: how often phase 6's comparison would fail a step that differs
    from the reference by rounding only, for each floor of ``PROBE_FLOORS``. Over
    ``n_states`` training states (one epoch apart), three draws of a ``PROBE_ROUNDING``
    change of every weight, each read as phase 6 reads the card's error (the largest
    change of a leaf over max(1e-4 of its largest gradient, 8x the floor); above 1
    fails)."""
    from tdal_torch.data.detection import collate_detection
    from tdal_torch.pipeline.detector_run import train_detector

    readings = {name: [] for name in PROBE_FLOORS}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        cfg, model, state, ds, total_steps = pp_training(root)
        head = cfg.model["bbox_head"]
        batch = collate_detection([ds[i] for i in range(PP_BATCH)])
        t0 = time.perf_counter()
        for s in range(n_states):
            train_detector(state, ds, head["code_weights"], n_epoch=1, batch_size=PP_BATCH,
                           logger=logging.getLogger("chip_smoke"), work_dir=root / f"s{s}",
                           weight=head["weight"], log_every=1)

            def grads(perturb=0.0, seed=1):
                return step_with_grads(model, batch, device, cfg, total_steps, perturb,
                                       seed)[1]

            g0 = grads()
            change = {t: {k: float((g[k] - g0[k]).abs().max()) for k in g0}
                      for t, g in zip(NOISE_TERMS, noise_grads_of(model, batch, device, cfg,
                                                                  total_steps))}
            worst = {}
            for draw in range(3):
                g = grads(PROBE_ROUNDING, seed=10 + draw)
                for name, terms in PROBE_FLOORS.items():
                    reading = max(
                        (float((g[k] - g0[k]).abs().max()) / max(
                            1e-4 * float(g0[k].abs().max()) + 1e-6,
                            GRAD_NOISE_MARGIN * max(change[t][k] for t in terms)), k)
                        for k in g0)
                    readings[name].append(reading[0])
                    worst[name] = max(worst.get(name, (0.0, "")), reading)
            log(f"  state {s}: worst of 3 draws " + "; ".join(
                f"{name} {r:.3f} ({k})" for name, (r, k) in worst.items())
                + f"; {time.perf_counter() - t0:.0f} s")
    summary = {}
    for name, values in readings.items():
        values.sort()
        summary[name] = dict(median=values[len(values) // 2], max=values[-1],
                             over_1=sum(v > 1 for v in values), n=len(values))
        log(f"  floor {name} ({', '.join(PROBE_FLOORS[name])}): {summary[name]['over_1']} "
            f"of {len(values)} rounding-level steps fail; median {summary[name]['median']:.4g}"
            f", largest {summary[name]['max']:.4g} of the tolerance")
    return summary


# phase 13: a checkpoint that tdal wrote, read without orbax and served on the card
TDAL_FIXTURE = Path(__file__).resolve().parent / "tests" / "data" / "tdal_ckpt"
# the packages the port's reader replaces: the reading child cannot import them
READER_BLOCKED = ("jax", "orbax", "tensorstore", "zstandard", "zarr", "numcodecs")


def _flat_tree(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _same_leaves(tree, expected: dict, prefix: str, what: str) -> int:
    """Every leaf of ``tree`` bit for bit equal to ``expected``'s under ``prefix``, and
    no leaf missing: the number of leaves."""
    got = _flat_tree(tree)
    want = {k[len(prefix):]: v for k, v in expected.items() if k.startswith(prefix)}
    if got.keys() != want.keys():
        raise AssertionError(f"{what}: leaves {sorted(got.keys() ^ want.keys())[:6]} differ")
    for k, v in want.items():
        g = np.asarray(got[k])
        if g.dtype != v.dtype or g.shape != v.shape or g.tobytes() != v.tobytes():
            raise AssertionError(f"{what}: leaf {k} is not bit-equal to tdal's")
    return len(want)


def read_tdal_variants(fixture: Path, tmp: Path) -> dict:
    """The reading half of phase 13, run in a fresh process (``--tdal-read-child``)
    where ``READER_BLOCKED`` cannot be imported: every variant of the fixture through
    ``load_checkpoint_uri`` (the manager directory's latest and, through
    ``restore_tdal``, its best step; a ``file://`` tarball made here, twice, the second
    time from the cache; the ``.npz``; the legacy layout through
    ``migrate_legacy_conv_params``), each leaf bit-equal to ``expected.npz``."""
    import tarfile

    for name in READER_BLOCKED:
        sys.modules[name] = None
    from tdal_torch.runtime.checkpoint import (
        load_checkpoint_uri, migrate_legacy_conv_params, restore_tdal,
    )

    expected = dict(np.load(fixture / "expected.npz"))

    def size(path: Path) -> int:
        return sum(f.stat().st_size for f in path.rglob("*") if f.is_file()) \
            if path.is_dir() else path.stat().st_size

    tarball = tmp / "ckpt.tar.gz"
    with tarfile.open(tarball, "w:gz") as tf:
        tf.add(fixture / "ckpt", arcname="ckpt")
    step1, step2 = fixture / "ckpt" / "ckpt_00000001", fixture / "ckpt" / "ckpt_00000002"
    reads = [
        ("directory, latest step", lambda: load_checkpoint_uri(str(fixture / "ckpt")),
         "step2/", size(step2)),
        ("directory, best step", lambda: restore_tdal(fixture / "ckpt", prefer_best=True),
         "step1/", size(step1)),
        ("file:// tarball", lambda: load_checkpoint_uri(f"file://{tarball}",
                                                        cache_dir=tmp / "cache"),
         "step2/", size(tarball) + size(step2)),
        ("file:// tarball, cached", lambda: load_checkpoint_uri(f"file://{tarball}",
                                                                cache_dir=tmp / "cache"),
         "step2/", size(step2)),
        (".npz", lambda: load_checkpoint_uri(str(fixture / "tree.npz")), "step2/",
         size(fixture / "tree.npz")),
        ("legacy layout, migrated", lambda: (migrate_legacy_conv_params(
            load_checkpoint_uri(str(fixture / "legacy"))[0]), None), "step2/",
         size(fixture / "legacy" / "ckpt_00000002")),
    ]
    out, nbytes, seconds = {}, 0, 0.0
    for what, read, prefix, n in reads:
        t0 = time.perf_counter()
        tree, _ = read()
        seconds += time.perf_counter() - t0
        nbytes += n
        out[what] = _same_leaves(tree, expected, prefix, what)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in READER_BLOCKED
                    and sys.modules[m] is not None)
    if loaded:
        raise AssertionError(f"the reader loaded {loaded}")
    return dict(leaves=out, bytes=nbytes, seconds=seconds, mb_per_s=nbytes / seconds / 1e6)


def serve_tdal_checkpoint(device, fixture: Path, tmp: Path) -> dict:
    """The serving half of phase 13: ``dist_test --checkpoint`` on the fixture's
    manager directory over the two frames of the config's ``fixture_frames`` (made here
    by ``tdal_torch.data.synthetic``), TF32 off; the same weights' head maps in this
    process against tdal's recorded maps (within ``MAP_TOL``) and, frame by frame, the
    kept candidates against those of tdal's maps (equal but for knife edges, counted);
    then the CLI's detections against tdal's ``run_inference`` output, equal within
    ``MAP_TOL`` in every frame whose kept sets are equal."""
    import os
    import pickle

    from tdal_torch.convert import load_tdal_checkpoint
    from tdal_torch.data.detection import DetectionDataset
    from tdal_torch.data.synthetic import make_synthetic_dataset
    from tdal_torch.models.builder import (
        build_assigner, build_detector, build_test_cfg, build_voxel_config,
    )
    from tdal_torch.models.center_head import decode_preds
    from tdal_torch.runtime.config import Config

    config = fixture / "pp_narrow.py"
    cfg = Config.fromfile(str(config))
    infos, _ = make_synthetic_dataset(tmp / "frames", **cfg.fixture_frames)
    expected = dict(np.load(fixture / "expected.npz"))
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "tdal_torch.tools.dist_test", str(config),
           "--work_dir", str(tmp / "serve"), "--checkpoint", str(fixture / "ckpt"),
           "--info_path", str(tmp / "frames" / "infos.pkl"), "--batch_size", "2"]
    if device.type == "cpu":
        cmd += ["--device", "cpu"]
    res = subprocess.run(cmd, cwd=fixture.parents[2], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, NVIDIA_TF32_OVERRIDE="0"))
    if res.returncode:
        raise AssertionError(f"dist_test exited {res.returncode}: {res.stderr[-2000:]}")
    cli_s = time.perf_counter() - t0
    with open(tmp / "serve" / "prediction.pkl", "rb") as f:
        preds = pickle.load(f)

    vox = build_voxel_config(cfg.voxel_generator, train=False)
    model = build_detector(cfg.model, vox, device=device)
    meta = load_tdal_checkpoint(model, fixture / "ckpt")
    test_cfg = build_test_cfg(cfg.test_cfg, model, vox)
    data = cfg.data["val"]
    ds = DetectionDataset(infos, data["class_names"],
                          build_assigner(cfg.train_cfg["assigner"], model), vox, mode="val",
                          max_points=data["max_points"], shuffle_points=False)
    points = torch.from_numpy(np.stack([ds[i]["points"] for i in range(len(ds))]))
    with torch.no_grad():
        maps = model.eval()(points.to(device))
    worst, counts, unexplained, differing, kept = {}, {}, [], {}, 0
    for t, task in enumerate(maps):
        ref = {k[len(f"maps/{t}/"):]: torch.from_numpy(v) for k, v in expected.items()
               if k.startswith(f"maps/{t}/")}
        for k, v in ref.items():
            err = (task[k].cpu() - v).abs() / v.abs().clamp_min(1)
            worst[k] = max(worst.get(k, 0.0), float(err.max()))
        bc, hc = decode_preds({k: v.cpu() for k, v in task.items()}, test_cfg)
        bp, hp = decode_preds(ref, test_cfg)
        for f in range(bc.shape[0]):
            kc, _, _ = kept_candidates(bc[f], hc[f], test_cfg)
            kp, sp, boxes_p = kept_candidates(bp[f], hp[f], test_cfg)
            c, u = explain_kept_difference(kc, kp, sp, boxes_p, test_cfg)
            kept += len(kp)
            differing[f] = differing.get(f, 0) + len(set(kc.tolist()) ^ set(kp.tolist()))
            for k, v in c.items():
                counts[k] = counts.get(k, 0) + v
            unexplained += [(t, f, int(i)) for i in u]
    bad = [k for k, v in worst.items() if not v <= MAP_TOL]
    if bad or unexplained:
        raise AssertionError(f"tdal's checkpoint on the card: maps {bad} beyond {MAP_TOL} "
                             f"({worst}), kept candidates {unexplained[:10]} unexplained")
    tokens = [info["token"] for info in infos]
    if sorted(preds) != sorted(tokens):
        raise AssertionError(f"dist_test predicted {sorted(preds)}, expected {tokens}")
    det_err, compared = 0.0, 0
    for f, token in enumerate(tokens):
        if differing[f]:
            continue  # a knife edge of this frame, counted above
        for k in ("box3d_lidar", "scores", "label_preds"):
            got, want = np.asarray(preds[token][k]), expected[f"pred/{token}/{k}"]
            if got.shape != want.shape:
                raise AssertionError(f"dist_test {token} {k}: shape {got.shape}, tdal's "
                                     f"{want.shape}")
            err = np.abs(got.astype(np.float64) - want) / np.maximum(1.0, np.abs(want))
            det_err = max(det_err, float(err.max(initial=0.0)))
        compared += 1
    if not det_err <= MAP_TOL:
        raise AssertionError(f"dist_test's detections differ from tdal's by {det_err:.3e}")
    return dict(map_rel_err=worst, kept_tdal=kept, differing=sum(differing.values()),
                knife_edge=counts, frames_compared=compared, det_rel_err=det_err,
                cli_s=cli_s, meta=meta)


def phase_tdal_checkpoint(device) -> dict:
    """Phase 13: read ``TDAL_FIXTURE`` in a fresh process that cannot import
    ``READER_BLOCKED`` (``read_tdal_variants``), then serve it on ``device``
    (``serve_tdal_checkpoint``)."""
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--tdal-read-child", str(TDAL_FIXTURE), tmp],
                             capture_output=True, text=True, timeout=300)
        if res.returncode:
            raise AssertionError(f"the reading child exited {res.returncode}: "
                                 f"{res.stderr[-3000:]}")
        read = json.loads(res.stdout.strip().splitlines()[-1])
        log(f"  (a) read {sum(read['leaves'].values())} leaves over {len(read['leaves'])} "
            f"variants bit-equal to tdal's without {', '.join(READER_BLOCKED)}: "
            f"{read['bytes']} bytes in {read['seconds']:.3f} s, {read['mb_per_s']:.2f} MB/s")
        serve = serve_tdal_checkpoint(device, TDAL_FIXTURE, Path(tmp))
    log(f"  (b) dist_test served the checkpoint (step {serve['meta'].get('step')}) in "
        f"{serve['cli_s']:.1f} s; head maps' errors against tdal's (tol {MAP_TOL:.0e}) "
        + ", ".join(f"{k} {v:.3e}" for k, v in serve["map_rel_err"].items())
        + f"; {serve['kept_tdal']} boxes kept by tdal, {serve['differing']} on one side "
        f"only: knife edges {serve['knife_edge']}; detections of "
        f"{serve['frames_compared']} frames within {serve['det_rel_err']:.3e}")
    return dict(read=read, serve=serve, seconds=time.perf_counter() - t_start)


# ---------------------------------------------------------------------------
# phase 14: BEV spatial partitioning on the card
# ---------------------------------------------------------------------------

# A whole-script run by phase from before the CPU lane (an NVIDIA H100 80GB HBM3 at
# 700.00 W, with the CPU copies of the card-vs-CPU checks inside phases 6, 9 and 12),
# printed beside this run's as text, never as this run's numbers
INLINE_CARD = "NVIDIA H100 80GB HBM3 at 700.00 W"
INLINE_SECONDS = {"2": 30.0, "3": 2.7, "4": 4.8, "5": 27.7, "6": 327.8, "7": 32.4, "8": 63.5,
                "9": 180.1, "10": 60.8, "11": 17.3, "12": 237.2, "13": 20.5}
SP_WORLD = 2  # two ranks: a spatial group sharing the card (gloo), or two cards (NCCL)
SP_FORWARDS = 4  # (a)'s forward timed: medians of the last 3 of 4, synchronised


def sp_forward_ms(model, points) -> tuple:
    """``model``'s eval forward of ``points``: (maps, median ms of the last 3 of
    ``SP_FORWARDS``, synchronised)."""
    times = []
    with torch.no_grad():
        for _ in range(SP_FORWARDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            maps = model(points)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    return maps, 1e3 * statistics.median(times[1:])


def _sp_rank(mesh, job_file, out_dir):
    """A spawned rank of phase 14: (a) the eval forward with the BEV stack partitioned
    over the spatial group (the rows this rank holds at each RPN level, the forward's
    ms, rank 0's gathered maps); (b) where the job asks, ``step_with_grads`` partitioned,
    sound and under each of ``SP_CONTROLS``, under ``deterministic``, with the conv
    launch counters from 0 for the sound step. Rank 0 saves its steps, every rank its
    state after the sound step and its launches."""
    from tdal_torch.ops import conv3x3 as cv
    from tdal_torch.parallel.controls import SP_CONTROLS, control
    from tdal_torch.parallel.mesh import spatial_sharding, spatial_slab
    from tdal_torch.runtime.config import Config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    job = torch.load(job_file, weights_only=False)
    model = copy.deepcopy(job["model"]).to(mesh.device).eval()
    model.bev_sharding = spatial_sharding(mesh)
    slab = spatial_slab(mesh, int(model.voxel_cfg.grid_size[1]),
                        int(np.prod(model.rpn.ds_layer_strides)))
    rows, level = {}, slab
    for stride in (1, *model.rpn.ds_layer_strides[1:]):
        level = level.scaled(1, stride)
        rows[level.height] = (level.start, level.stop)
    maps, fwd_ms = sp_forward_ms(model, job["points"].to(mesh.device))
    out = dict(rows=rows, forward_ms=fwd_ms)
    if mesh.rank == 0:
        out["maps"] = [{k: v.cpu() for k, v in m.items()} for m in maps]
    if job["train"] is not None:
        cfg = Config(job["train"]["cfg"])
        steps = {}
        for name in (None, *SP_CONTROLS):
            for counts in (cv.launches, cv.halo_launches):
                counts.update(dict.fromkeys(counts, 0))
            with deterministic(), control(name):
                steps[name] = step_with_grads(job["train"]["model"], job["train"]["batch"],
                                              mesh.device, cfg, job["train"]["n_steps_total"],
                                              mesh=mesh, spatial=True)
            if name is None:
                out.update(launches=dict(cv.launches), halo_launches=dict(cv.halo_launches))
        out["state"] = steps[None][2]
        if mesh.rank == 0:
            out["steps"] = steps
    torch.save(out, Path(out_dir) / f"{mesh.rank}.pt")


def sp_ranks(job: dict, devices, backend, root: Path) -> list:
    """``_sp_rank`` in ``len(devices)`` spawned ranks of one spatial group."""
    from tdal_torch.parallel.mesh import spawn

    root.mkdir(parents=True, exist_ok=True)
    torch.save(job, root / "job.pt")
    spawn(_sp_rank, (str(root / "job.pt"), str(root)), devices=devices, backend=backend,
          spatial=len(devices))
    return [torch.load(root / f"{r}.pt", weights_only=False) for r in range(len(devices))]


def sp_maps_line(tag, got, want, test_cfg) -> dict:
    """(a)'s verdict on one run: the gathered maps against the one-process forward's,
    held by ``compare_maps`` (``MAP_TOL``; kept sets equal but for knife edges)."""
    cmp = compare_maps(got, want, test_cfg)
    log(f"    {tag}: the gathered maps against the one-process forward, decoded (tol "
        f"{MAP_TOL:.0e}): " + ", ".join(f"{k} {v:.3e}" for k, v in cmp["map_rel_err"].items())
        + f"; {cmp['kept_ref']} boxes kept by one process, {cmp['differing']} on one side "
        f"only: knife edges {cmp['knife_edge']}, unexplained {cmp['unexplained']}")
    failures = [k for k, v in cmp["map_rel_err"].items()
                if not v <= MAP_TOL and k != "heading (rad)"]
    if failures or cmp["unexplained"]:
        raise AssertionError(f"phase 14 {tag}: the partitioned forward differs from one "
                             f"process: maps {failures}, kept sets {cmp['unexplained_at'][:10]}")
    del cmp["unexplained_at"]
    return cmp


def phase7_points(cfg, device) -> torch.Tensor:
    """The first ``INFER_BATCH`` of phase 7's test frames (its synthetic split at the
    config's test settings), on the CPU: phase 14's batch when phase 7 did not run."""
    from tdal_torch.data.detection import DetectionDataset
    from tdal_torch.data.synthetic import make_synthetic_dataset
    from tdal_torch.models.builder import build_assigner, build_detector, build_voxel_config

    voxel_cfg = build_voxel_config(cfg.voxel_generator, train=False)
    model = build_detector(cfg.model, voxel_cfg, device="cpu", seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        infos, _ = make_synthetic_dataset(Path(tmp) / "test", **PP_TEST_DATA)
        ds = DetectionDataset(infos, cfg.class_names, build_assigner(cfg.assigner, model),
                              voxel_cfg, mode="test", max_points=cfg.data["val"]["max_points"])
        return torch.as_tensor(np.stack([ds[i]["points"] for i in range(INFER_BATCH)]))


def phase_spatial(device, pp_state, points, reference=None) -> dict:
    """Phase 14: BEV spatial partitioning of the Waymo PP config at full width (468^2
    canvas, RPN (3, 5, 5) at 64/128/256) with phase 6's snapshot ``pp_state``, f32, TF32
    off, on two gloo ranks sharing the card (NCCL refuses two ranks on one device).
    First ``conv_halo_twin_checks`` at the phase's slab shapes. (a) ``points`` (a batch of 4 of phase 7's test frames) through the eval forward:
    each rank's rows at every RPN level, rank 0's gathered maps against the
    one-process forward on the card (``compare_maps``). (b) One train step of the
    global batch of 4, both ranks holding it whole, under ``deterministic``, against the
    single-process step on the card (``reference``: phase 10 (a)'s, the same step, floor
    and batch; measured here without it), held by ``compare_steps`` with its noise
    floor; each reading printed as a share of its tolerance; both ranks' states equal;
    both ``SP_CONTROLS`` must fail on the gradients; each rank launches phase 6's
    counts, every one in the halo form. (c) Where the machine has two cards, (a) over
    NCCL across two, its forward's ms a batch and frames/s beside one card's."""
    from tdal_torch.data.detection import collate_detection
    from tdal_torch.models.builder import build_test_cfg, build_voxel_config
    from tdal_torch.parallel.controls import SP_CONTROLS

    t_start = time.perf_counter()
    log(f"  the conv kernels' halo forms against their twins on this phase's row slabs "
        f"({SP_WORLD} ranks), f32, tolerances as phase 5's")
    out = {"halo_twins": conv_halo_twin_checks(device)}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        cfg, model, _, ds, total_steps = pp_training(root / "data")
        model = model.cpu()
        model.load_state_dict(pp_state)
        if reference is None:
            batch = first_frames(collate_detection([ds[i] for i in range(PP_BATCH)]), PP_BATCH)
            with deterministic():
                single = step_with_grads(model, batch, device, cfg, total_steps)
                noise = noise_steps_of(model, batch, device, cfg, total_steps)
            reference = dict(single=single, noise_grads=[n[1] for n in noise],
                             noise_states=[n[2] for n in noise], batch=batch,
                             n_steps_total=total_steps, source="measured here")
            del noise
        # (a) at the test settings, as phase 7's forward; (b) at the training ones
        vox_test = build_voxel_config(cfg.voxel_generator, train=False)
        test_cfg = build_test_cfg(cfg.test_cfg, model, vox_test)
        eval_model = copy.deepcopy(model)
        eval_model.voxel_cfg = vox_test
        one = copy.deepcopy(eval_model).to(device).eval()
        maps_one, one_ms = sp_forward_ms(one, points.to(device))
        del one
        train_model = model
        job = dict(model=eval_model, points=points, train=dict(
            model=train_model, cfg=cfg.to_dict(), batch=reference["batch"],
            n_steps_total=reference["n_steps_total"]))
        t0 = time.perf_counter()
        ranks = sp_ranks(job, ["cuda:0"] * SP_WORLD, "gloo", root / "ranks")
        ranks_s = time.perf_counter() - t0

        # (a)
        log(f"  (a) the eval forward of {len(points)} of phase 7's test frames on "
            f"{SP_WORLD} gloo ranks sharing the card ({ranks_s:.1f} s with the spawn and the "
            f"train steps of (b))")
        for r, res in enumerate(ranks):
            log(f"    rank {r}'s rows: " + ", ".join(
                f"{b - a} [{a}, {b}) of {height}" for height, (a, b) in res["rows"].items()))
        out["rows"] = [res["rows"] for res in ranks]
        out["a"] = sp_maps_line("two ranks on one card", ranks[0]["maps"], maps_one, test_cfg)
        out["a"].update(forward_ms=ranks[0]["forward_ms"], one_process_forward_ms=one_ms)
        log(f"    the partitioned forward {ranks[0]['forward_ms']:.1f} ms a batch on one card "
            f"(two ranks sharing it) beside {one_ms:.1f} ms in one process")

        # (b)
        single = reference["single"]
        steps = ranks[0]["steps"]
        as_card = lambda s: (s[0], s[1], s[2], s[4])  # noqa: E731
        ref = (single[0], single[1], single[2], single[4])
        worst, failures, leaves = compare_steps(train_model, as_card(steps[None]), ref,
                                                reference["noise_grads"], single[3],
                                                reference["noise_states"])
        readings = {"sound": worst}
        log(f"  (b) one train step at a global batch of {len(reference['batch']['points'])}, "
            f"both ranks holding it, against one process on the card ("
            + reference["source"] + f"): loss {steps[None][0]:.6f} / {single[0]:.6f}; shares of the tolerances: "
            f"{share_line(worst)}")
        for ratio, k, err, scale, nz in sorted(leaves, reverse=True)[:3]:
            log(f"    gradient {k}: error {err:.3e} = {ratio:.3f} of tolerance; largest "
                f"gradient {scale:.3e}, noise floor {nz:.3e}")
        for name in SP_CONTROLS:
            readings[name], c_fail, _ = compare_steps(
                train_model, as_card(steps[name]), ref, reference["noise_grads"], single[3],
                reference["noise_states"])
            log(f"  control ({name}): {len(c_fail)} failures; {share_line(readings[name])}")
            if not readings[name]["grad_err_over_tol"] > 1:
                failures.append(f"control {name}: its gradients pass the comparison")
        for r, res in enumerate(ranks[1:], 1):
            unequal = [k for k, v in ranks[0]["state"].items()
                       if not torch.equal(v, res["state"][k])]
            if unequal:
                failures.append(f"rank {r}'s state differs from rank 0's: {unequal[:3]}")
        for r, res in enumerate(ranks):
            log(f"    rank {r}: launches {res['launches']}, in the halo form "
                f"{res['halo_launches']}")
            if res["launches"] != PP_LAUNCHES or res["halo_launches"] != PP_LAUNCHES:
                failures.append(f"rank {r}: launches {res['launches']} (halo form "
                                f"{res['halo_launches']}), expected {PP_LAUNCHES} all in the "
                                "halo form")
        if failures:
            raise AssertionError("phase 14 (b): " + "; ".join(failures[:10]))
        out["b"] = dict(readings=readings, loss_sp=steps[None][0], loss_single=single[0],
                        launches=[res["launches"] for res in ranks],
                        halo_launches=[res["halo_launches"] for res in ranks],
                        ranks_s=ranks_s)

        # (c)
        if torch.cuda.device_count() >= 2:
            job["train"] = None
            two = sp_ranks(job, ["cuda:0", "cuda:1"], "nccl", root / "two_cards")
            out["c"] = sp_maps_line("two cards over NCCL", two[0]["maps"], maps_one, test_cfg)
            ms = two[0]["forward_ms"]
            out["c"].update(forward_ms=ms, frames_per_s=len(points) / ms * 1e3,
                            one_card_frames_per_s=len(points) / one_ms * 1e3)
            log(f"  (c) two cards over NCCL: the forward {ms:.1f} ms a batch of {len(points)}, "
                f"{out['c']['frames_per_s']:.2f} frames/s against "
                f"{out['c']['one_card_frames_per_s']:.2f} on one card ({one_ms / ms:.3f}x)")
        else:
            log("  one card: (c) not run")
            out["c"] = "one card: not run"
    out["seconds"] = time.perf_counter() - t_start
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--noise-probe", type=int, default=0, metavar="STATES",
                        help="build, then run only the noise-floor probe over STATES "
                             "training states (see noise_probe)")
    parser.add_argument("--offboard-only", action="store_true",
                        help="build, then run only phase 8 from phase 6's snapshot")
    parser.add_argument("--voxelnet-only", action="store_true",
                        help="build, then run only phase 9")
    parser.add_argument("--dp-only", action="store_true",
                        help="build, then run only phase 10 from phase 6's snapshot")
    parser.add_argument("--pp-only", action="store_true",
                        help="build, then run only phase 6")
    parser.add_argument("--data-prep-only", action="store_true",
                        help="build, then run only phase 11 from a fresh detector")
    parser.add_argument("--dcn-only", action="store_true",
                        help="build, then run only phase 12")
    parser.add_argument("--sp-only", action="store_true",
                        help="build, then run only phase 14 from phase 6's snapshot")
    parser.add_argument("--import-only", action="store_true",
                        help="run only phase 13: read tdal's checkpoint fixture without "
                             "orbax and serve it (no kernel build: it launches none)")
    parser.add_argument("--tdal-read-child", nargs=2, metavar=("FIXTURE", "TMP"),
                        help=argparse.SUPPRESS)
    parser.add_argument("--library-times", action="store_true",
                        help="only time phase 5's cuDNN calls in benchmark mode and print "
                             "them as one JSON line (the whole script runs this in a child "
                             "process during phase 12's CPU work)")
    args = parser.parse_args()
    if args.tdal_read_child:  # phase 13's reading child, which runs on the host alone
        fixture, tmp = map(Path, args.tdal_read_child)
        print(json.dumps(read_tdal_variants(fixture, tmp)))
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    if args.library_times:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(json.dumps(library_times(torch.device("cuda"))))
        return 0
    from tdal_torch.ops import fused_pointnet as fp
    from tdal_torch.ops.build import kernels

    # phase 1: the device
    seconds, t_phase = {}, time.perf_counter()
    t_script = t_phase

    def lap(phase):
        """Seconds since the previous phase ended, kept under the phase's number."""
        nonlocal t_phase
        now = time.perf_counter()
        seconds[phase], t_phase = round(now - t_phase, 1), now

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"phase 1 device: {kind}; torch {torch.__version__} CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    logging.basicConfig(level=logging.INFO, stream=sys.stdout, format="  %(message)s")
    if args.import_only:
        log("phase 13 a checkpoint of tdal's, read without orbax and served (alone)")
        imported = phase_tdal_checkpoint(device)
        log(f"  phase 13 seconds: {imported['seconds']:.1f}")
        print(json.dumps(imported, default=str))
        log(f"card: {kind} | {smi}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return 0

    log("phase 2 build")
    t0 = time.perf_counter()
    lib = kernels()
    log(f"  the kernels built with nvcc (or a build of the same sources loaded) in "
        f"{time.perf_counter() - t0:.1f} s")
    regs = [int(w) for w in re.findall(r"Used (\d+) registers", lib.build_log)]
    spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill stores", lib.build_log))
    log(f"  ptxas: {len(regs)} kernels, at most {max(regs)} registers a thread, "
        f"{spills} bytes of spill stores in all")
    t0 = time.perf_counter()
    seg_rows = seg_build_report(lib.build_log, lib)
    log(f"  K1/K2 build report, cuobjdump of their SASS included, in "
        f"{time.perf_counter() - t0:.1f} s")
    for r in seg_rows:
        log(f"    {r['kernel']}: {r['registers']} registers, {r['dynamic_smem']} B dynamic + "
            f"{r['static_smem']} B static shared memory, stack {r['stack']} B, spills "
            f"{r['spill_stores']} B stored / {r['spill_loads']} B loaded; SASS: {r['hgmma']} "
            f"HGMMA, {r['hmma']} HMMA")
    no_wgmma = [r["kernel"] for r in seg_rows
                if r["kernel"] != "seg_encoder_reduce_kernel" and r["hgmma"] == 0]
    if len(seg_rows) != 7 or no_wgmma:
        raise AssertionError(f"K1/K2 build report: {len(seg_rows)} kernels (7 expected), "
                             f"without HGMMA: {no_wgmma}")
    for r in conv_build_report(lib.build_log, lib):
        log(f"    {r['kernel']}: {r['registers']} registers, {r['dynamic_smem']} B dynamic + "
            f"{r['static_smem']} B static shared memory, spills {r['spill_stores']} B stored / "
            f"{r['spill_loads']} B loaded")
    if args.noise_probe:
        log("noise-floor probe")
        print(json.dumps(noise_probe(device, args.noise_probe)))
        return 0
    if args.offboard_only:
        log("phase 8 the offboard chain (alone, from phase 6's snapshot)")
        with tempfile.TemporaryDirectory() as tmp:
            cfg, model = pp_snapshot(Path(tmp))[:2]
            snapshot = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        del model
        print(json.dumps(phase_offboard(device, cfg, snapshot), default=str))
        return 0
    if args.voxelnet_only:
        log("phase 9 VoxelNet and the two-stage detector (alone)")
        voxelnet = phase_voxelnet(device)
        voxelnet["train"].update(voxelnet["train"].pop("check").result())
        print(json.dumps(voxelnet, default=str))
        return 0
    if args.pp_only:
        log("phase 6 PointPillars training on the Waymo config (alone)")
        t0 = time.perf_counter()
        train = phase_train(device)[0]
        train.update(train.pop("check").result())
        log(f"  phase 6 seconds: {time.perf_counter() - t0:.1f}")
        print(json.dumps({k: v for k, v in train.items() if k != "profiled_step"},
                         default=str))
        return 0
    if args.data_prep_only:
        log("phase 11 data preparation and GT-aug training (alone, from a fresh detector)")
        t0 = time.perf_counter()
        prep = phase_data_prep(device)
        log(f"  phase 11 seconds: {time.perf_counter() - t0:.1f}")
        print(json.dumps(prep, default=str))
        return 0
    if args.dcn_only:
        log("phase 12 the deformable head on the two-sweep velocity VoxelNet (alone)")
        t0 = time.perf_counter()
        dcn = phase_dcn(device)
        dcn["check"].update(dcn["check"].pop("pending").result())
        log(f"  phase 12 seconds: {time.perf_counter() - t0:.1f}; peak memory "
            f"{dcn['peak_gib']:.2f} GiB")
        print(json.dumps(dcn, default=str))
        return 0
    if args.dp_only:
        log("phase 10 data parallelism (alone, from phase 6's snapshot)")
        with tempfile.TemporaryDirectory() as tmp:
            model = pp_snapshot(Path(tmp))[1]
            snapshot = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        del model
        dp = phase_data_parallel(device, snapshot)
        dp["a"].pop("reference")
        print(json.dumps(dp, default=str))
        return 0
    if args.sp_only:
        log("phase 14 BEV spatial partitioning (alone, from phase 6's snapshot)")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            cfg, model = pp_snapshot(Path(tmp))[:2]
            snapshot = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        del model
        sp = phase_spatial(device, snapshot, phase7_points(cfg, device))
        log(f"  phase 14 seconds: {time.perf_counter() - t0:.1f}")
        print(json.dumps(sp, default=str))
        log(f"card: {kind} | {smi}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return 0

    global LANE
    LANE = cpu_lane()
    try:
        return whole_run(device, kind, smi, seconds, lap, t_script, fp)
    except BaseException:
        for proc in multiprocessing.active_children():  # the lane, maybe mid-job
            proc.kill()
        raise
    finally:
        LANE.shutdown(cancel_futures=True)


def whole_run(device, kind, smi, seconds, lap, t_script, fp) -> int:
    """Phases 3-16 of the whole script, after the device and the build (phases 1-2)."""
    lap(2)

    log("phase 3 kernels against their twins")
    kres = phase_kernels(device)
    lap(3)
    log(f"  launches in phase 3 (checks and timing, not counted below): {dict(fp.launches)}")

    log("phase 4 stages 2-6 end to end")
    chain = phase_chain(device)
    lap(4)

    log("phase 5 conv kernels against their twins (cuDNN's times come at the end)")
    from tdal_torch.ops import conv3x3 as cv

    cres, chalo = phase_conv(device)
    lap(5)
    log(f"  launches in phase 5 (checks and timing, not counted below): {dict(cv.launches)}")

    log("phase 6 PointPillars training on the Waymo config")
    train, pp_cfg, pp_model, pp_state = phase_train(device)
    lap(6)

    log("phase 7 PointPillars inference on the Waymo config")
    infer, infer_points = phase_infer(device, pp_cfg, pp_model)
    lap(7)

    log("phase 8 the offboard chain: labeler training, then the detector-fed chain")
    offboard = phase_offboard(device, pp_cfg, pp_state)
    lap(8)
    del pp_model
    torch.cuda.empty_cache()

    log("phase 9 sparse VoxelNet training and inference, and the two-stage detector")
    voxelnet = phase_voxelnet(device)
    lap(9)
    torch.cuda.empty_cache()

    log("phase 10 data parallelism: two ranks on one card, one NCCL rank, two cards")
    dp = phase_data_parallel(device, pp_state, train["frames_per_s"])
    sp_reference = dict(dp["a"].pop("reference"), source="phase 10 (a)'s step and floor")
    lap(10)

    log("phase 11 the port's data preparation and GT-aug training on the Waymo PP config")
    prep = phase_data_prep(device, pp_state)
    lap(11)
    torch.cuda.empty_cache()

    log("phase 12 the deformable head on the two-sweep velocity VoxelNet")
    dcn = phase_dcn(device)
    lap(12)

    log("phase 13 a checkpoint of tdal's, read without orbax and served on the card")
    imported = phase_tdal_checkpoint(device)
    lap(13)

    log("phase 14 BEV spatial partitioning: two ranks on one card, two cards")
    sp = phase_spatial(device, pp_state, infer_points, sp_reference)
    del sp_reference
    lap(14)

    log("the card-vs-CPU checks of phases 6, 9 and 12, their CPU copies from the CPU lane "
        "(cuDNN's times for phase 5 meanwhile, on the idle card)")
    library = LibraryTimes()
    try:
        wait_library = library.start()
        train.update(train.pop("check").result())
        voxelnet["train"].update(voxelnet["train"].pop("check").result())
        dcn["check"].update(dcn["check"].pop("pending").result())
        wait_library()
    finally:
        library.stop()
    lap("checks")
    log("phase 5's kernels beside cuDNN's times")
    attach_library_times(cres, library.ms)

    entries = []
    for name, by_case in kres.items():
        main_case = by_case["static f32"]  # the main path's mode, at the static labeler's shape
        entries.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=offboard["k1k2_launches"][name] + dp["c"]["eval_launches"][name],
            launches_by_path={
                "phase 4 stages 2-6": chain["launches"][name],
                "phase 8 labeler eval": sum(r["launches"][name]
                                            for r in offboard["labelers"].values()),
                "phase 8 chain": offboard["k1k2_launches"][name],
                "phase 10 (c) sharded eval, both ranks": dp["c"]["eval_launches"][name]},
            max_abs_err=main_case["max_abs_err"],
            ms=main_case["ms"], plain_ms=main_case["plain_ms"], bound_ms=main_case["bound_ms"],
            bound_by=main_case["bound_by"], library_ms=None,
            kernel_ms=main_case["kernel_ms"],
            shape="static B=64 N=4096 Cin=3, f32 operands", cases=by_case,
        ))
    for name, by_case in cres.items():
        proto = name == PROTO["name"]
        case = f"{PROTO['shape']} bf16" if proto else CONV_MAIN
        main_case = by_case[case]
        extra = {
            "conv3x3_wgrad": {"also_replaces": "tdal/ops/pallas_conv.py:622 (K6: in_act off)"},
            "conv3x3_dgrad_act": {"unfused_ms": main_case.get("unfused_ms"),
                                  "library": main_case.get("library")},
            # the prototype has no caller: its function is K4's, counted on the path
            PROTO["name"]: {"same_kernel_as": "conv3x3_fwd"},
        }.get(name, {})
        key = "conv3x3_fwd" if proto else name
        entries.append(dict(
            name=name, route="cuda", source=CONV_SOURCE,
            replaces=PROTO["replaces"] if proto else CONV_REPLACES[name],
            launches=(offboard["conv_launches"][key] + voxelnet["train"]["launches"][key]
                      + dp["b"]["launches"][key] + prep["launches"][key]
                      + dcn["train"]["launches"][key]
                      + sum(r[key] for r in sp["b"]["launches"])),
            launches_by_path={"phase 6 timed steps": train["launches"][key],
                              "phase 8 detector rounds": offboard["conv_launches"][key],
                              "phase 9 VoxelNet timed steps":
                                  voxelnet["train"]["launches"][key],
                              "phase 10 (b) timed steps, one NCCL rank":
                                  dp["b"]["launches"][key],
                              "phase 11 GT-aug timed steps": prep["launches"][key],
                              "phase 12 dcn VoxelNet steps": dcn["train"]["launches"][key],
                              "phase 14 (b) partitioned step, both ranks, halo form":
                                  sum(r[key] for r in sp["b"]["halo_launches"])},
            max_abs_err=main_case["max_abs_err"], ms=main_case["ms"],
            plain_ms=main_case["plain_ms"], bound_ms=main_case["bound_ms"],
            bound_by=main_case["bound_by"], library_ms=main_case["library_ms"],
            shape=f"{case}: B=4 468x468 64->64",
            halo_form=None if proto else dict(chalo[name], halo=[1, 1]), **extra,
        ))
    sk = voxelnet["infer"]["sparse_kernel"]
    sparse_by_path = {
        "phase 9 (a) VoxelNet timed steps": voxelnet["train"]["sparse_launches"],
        "phase 9 (b) run_inference": voxelnet["infer"]["sparse_launches"],
        "phase 9 (c) train_two_stage, the frozen first stage":
            voxelnet["two_stage"]["sparse_launches"],
        "phase 12 dcn VoxelNet steps": dcn["train"]["sparse_launches"]}
    entries.append(dict(
        name="sparse_conv", route="cuda", source=SPARSE_SOURCE, replaces=SPARSE_REPLACES,
        launches=sum(sparse_by_path.values()), launches_by_path=sparse_by_path,
        max_abs_err=sk["max_abs_err"], max_rel_err=sk["max_rel_err"], tol=SPARSE_TOL,
        ms=sk["kernel_ms"], plain_ms=sk["twin_ms"], bound_ms=sk["least_ms"],
        bound_by="each conv's real pairs' FLOP at the TF32 peak or its live rows' and "
                 "weights' bytes at 3.35 TB/s, the larger",
        ffma_ms=sk["ffma_ms"], library_ms=None,
        shape=f"the {len(VN_SPARSE_CONVS)} sparse convs of one eval forward of phase 9 (b)'s "
              f"batch of {INFER_BATCH} test frames (400000 voxels a frame at level 0), f32",
    ))
    # derived, not traced: phase 5's f32 kernel times at each conv site of the step
    kernel_ms = 0.0
    for shape, act, n in PP_SITE_CASES:
        case = f"{shape} f32" + (" in_act" if act else "")
        dgrad = "conv3x3_dgrad_act" if act else "conv3x3_fwd"
        kernel_ms += n * sum(cres[k][case]["ms"] for k in ("conv3x3_fwd_stats", dgrad,
                                                            "conv3x3_wgrad"))
    log(f"  derived: the {PP_SITES} conv sites' K3 + dgrad (K7 or K4) + K5 take "
        f"{kernel_ms:.1f} ms of the {train['step_ms']:.1f} ms step "
        f"({100 * kernel_ms / train['step_ms']:.0f}%)")
    train_summary = {k: v for k, v in train.items() if k != "launches"}
    log(f"  training summary: {json.dumps(train_summary)}")
    log(f"  inference summary: {json.dumps(infer)}")
    log(f"  offboard summary: {json.dumps(offboard, default=str)}")
    log(f"  VoxelNet summary: {json.dumps(voxelnet, default=str)}")
    log(f"  data-parallel summary: {json.dumps(dp, default=str)}")
    log(f"  data preparation summary: {json.dumps(prep, default=str)}")
    log(f"  deformable head summary: {json.dumps(dcn, default=str)}")
    log(f"  tdal checkpoint summary: {json.dumps(imported, default=str)}")
    log(f"  spatial partitioning summary: {json.dumps(sp, default=str)}")
    log(f"  seconds by phase (phase 2 from the start; \"checks\": the wait for the CPU lane "
        f"and the judging of phases 6, 9 and 12's checks): {json.dumps(seconds)}; the whole "
        f"script {time.perf_counter() - t_script:.1f}")
    log(f"  recorded, not this run's: a run without the CPU lane on {INLINE_CARD}, the CPU "
        f"copies inside phases 6, 9 and 12: {json.dumps(INLINE_SECONDS)}; the whole script "
        f"{sum(INLINE_SECONDS.values()):.1f}")
    log(f"card: {kind} | {smi}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
