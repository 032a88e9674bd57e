"""Mode ``train``: the detector's training loop, as ``train_detector`` composes it.

Set-up makes the frame pool from the seed and writes it where the port's
``DetectionDataset`` reads it; builds the configuration's detector and its optimizer
(AdamW under the OneCycle schedule of the published job, gradient clip) and loads the
benchmark's weights; then drives the train state through its first steps on the same
call and feed as the window: ``detection_batches`` over the pool (repeated, shuffled,
every draw freshly augmented) -> ``make_detector_steps``' ``train_step`` ->
``TrainState.apply_gradients``. The per-epoch checkpoint and log writes of
``train_detector`` are left out: at a real epoch of tens of thousands of steps they
are amortised away.

The window runs steps until ``--seconds`` have passed on the host's clock, then waits
for the card: ``train_frames_per_s`` is every frame of every step over that whole
time. A CUDA event recorded after each step's update gives the step intervals,
read once the window has closed. With ``--trace 1`` the first ``trace_steps`` steps of
the window run under ``torch.profiler`` (``common.Segment``).

Once the window has closed and the peak memory is read, the program is freed and the
plain reference (``portbench/reference``) repeats the first three steps from the same
weights and frames, working out the batches (augmentation draws, targets, voxels)
itself: each step's loss, the first gradient per parameter (the program's from its
AdamW state after one step), and each parameter's change over the three steps are
compared leaf by leaf.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import time

import numpy as np
import torch

from portbench import common, controls
from portbench.counts import work
from portbench.reference import data as ref_data
from portbench.reference import models as ref_models
from portbench.reference import optim as ref_optim
from portbench.traffic import waymo_raycast

SETUP_STEPS = 6  # three compared with the reference, then warm steps
COMPARED = 3


def _frames(run, device):
    p = run.traffic
    frames = waymo_raycast.make_pool(run.seed, p, device)
    vg = run.config["voxel_generator"]
    nx = int(work.grid_size(vg)[0])
    lo = torch.tensor(vg["range"][:2], device=device)
    vs = torch.tensor(vg["voxel_size"][:2], device=device)
    occupied = []
    for f in frames:  # pillars of the points in range
        ij = torch.floor((torch.as_tensor(f["points"][:, :2], device=device) - lo) / vs).long()
        ok = ((ij >= 0) & (ij < torch.as_tensor(work.grid_size(vg)[:2], device=device))).all(1)
        occupied.append(int(torch.unique(ij[ok, 1] * nx + ij[ok, 0]).numel()))
    run.readings["pillars"] = occupied
    run.log(f"{len(frames)} frames, {min(len(f['points']) for f in frames)}-"
            f"{max(len(f['points']) for f in frames)} points, "
            f"{min(len(f['gt_boxes']) for f in frames)}-{max(len(f['gt_boxes']) for f in frames)} "
            f"labelled boxes; occupied pillars {min(occupied)}-{max(occupied)} of the "
            f"{vg['max_voxel_num'][0]} cap")
    return frames


def run(run, t_start: float):
    from tdal_torch.data.detection import DetectionDataset
    from tdal_torch.models.builder import build_assigner, build_detector, build_voxel_config
    from tdal_torch.ops import conv3x3 as cv
    from tdal_torch.pipeline.detector_engine import make_detector_steps
    from tdal_torch.pipeline.detector_run import detection_batches
    from tdal_torch.runtime.schedules import adam_with_schedule, one_cycle
    from tdal_torch.runtime.train_state import TrainState

    cfg, p, dev = run.config, run.traffic, run.device
    common.set_tf32(False)  # the configurations state float32
    common.set_cudnn_benchmark(bool(run.cell["cudnn_benchmark"]))  # for the whole process
    batch = int(cfg["data"]["samples_per_gpu"])
    run.phase(t_start, "program imported")
    frames = _frames(run, dev)
    run.phase(t_start, "frames made")
    if dev.type == "cuda":  # the peak is the program's: set-up steps and window
        torch.cuda.reset_peak_memory_stats(dev)
    repeats = int(p["repeats"])
    infos = waymo_raycast.write_pool(frames, run.workdir / "pool")
    infos = [dict(info, token=f"{r}_{info['token']}") for r in range(repeats) for info in infos]
    run.phase(t_start, "frames made and written")

    vox = build_voxel_config(cfg["voxel_generator"], train=True)
    model = build_detector(cfg["model"], vox, device=dev)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    n_cls = int(cfg["tasks"][-1]["num_class"])
    weights = common.make_weights(shapes, lambda k, s: ref_models.param_fan_in(k, s, cfg),
                                  run.seed, dev, n_cls, float(run.cell["weights"]["hm_bias"]))
    model.load_state_dict(weights)
    params = [k for k, _ in model.named_parameters()]
    w0 = {k: weights[k].clone() for k in params}
    del weights
    head = cfg["model"]["bbox_head"]
    total_steps = ref_optim.total_steps(run.cell["config_file"], batch)
    lr, mom = one_cycle(cfg["lr_config"]["lr_max"], total_steps, tuple(cfg["lr_config"]["moms"]),
                        cfg["lr_config"]["div_factor"], cfg["lr_config"]["pct_start"])
    opt = adam_with_schedule(model.parameters(), lr, cfg["optimizer"]["wd"],
                             cfg["grad_clip"]["max_norm"], mom)
    state = TrainState(model, opt)
    pre = cfg["train_preprocessor"]
    ds = DetectionDataset(
        infos, cfg["class_names"], build_assigner(cfg["assigner"], model), vox, mode="train",
        max_points=cfg["data"]["train"]["max_points"],
        global_rot_noise=tuple(pre["global_rot_noise"]),
        global_scale_noise=tuple(pre["global_scale_noise"]),
        shuffle_points=pre["shuffle_points"], seed=_dataset_seed(run.seed))
    step = make_detector_steps(model, head["code_weights"], head["weight"])
    batches = (b for epoch in itertools.count() for b in detection_batches(
        ds, batch, shuffle=True, seed=_shuffle_seed(run.seed) + epoch))

    run.phase(t_start, "detector, optimizer and data built")
    common.set_tf32(controls.tf32_on(run))  # on only under the control
    # set-up: the first steps through the window's own call and feed
    losses0, grad1, delta3 = [], None, None
    for i in range(SETUP_STEPS):
        with common.profiler_warmed(run) if i == SETUP_STEPS - 1 else contextlib.nullcontext():
            logs = step(state, next(batches))
        if i < COMPARED:
            losses0.append(float(logs["loss"]))
        if i == 0:
            run.phase(t_start, "first step")
        if i == 0:  # AdamW's first moment after one step: (1 - b1) * the clipped gradient
            b1 = float(mom(0))
            grad1 = {k: (opt.state[pp]["m"].norm().item() / (1 - b1)
                         if "m" in opt.state.get(pp, {}) else math.inf)
                     for k, pp in model.named_parameters()}
        if i == COMPARED - 1:
            delta3 = {k: pp.detach() - w0[k] for k, pp in model.named_parameters()}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    run.readings["setup_s"] = time.perf_counter() - t_start
    run.log(f"set-up {run.readings['setup_s']:.2f} s; first losses {losses0}")

    # the window
    sites = work.conv3x3_sites(cfg, batch)
    per_step = work.conv3x3_launches(sites)
    waits, ends, losses = [], [], []
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        start_ev = torch.cuda.Event(enable_timing=True)
    segment = common.Segment(run, int(p["trace_steps"]))
    launches0 = dict(cv.launches)
    t0 = time.perf_counter()
    if cuda:
        start_ev.record()
    segment.start(t0)
    n = 0
    while True:
        tw = time.perf_counter()
        b = next(batches)
        waits.append(time.perf_counter() - tw)
        logs = step(state, b)
        losses.append(logs["loss"])
        n += 1
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ends.append(ev)
        if segment.tick(n, n * batch):  # launches over the traced stretch
            run.readings["trace_launches"] = {k: cv.launches[k] - launches0[k]
                                              for k in launches0}
        if time.perf_counter() - t0 >= run.seconds and not segment.open:
            break
    if cuda:
        torch.cuda.synchronize(dev)
    t_end = time.perf_counter()
    window = t_end - t0
    run.readings.update(
        window_s=window, steps=n, frames=n * batch, waits=waits,
        traced_steps=segment.steps if segment.after is not None else 0,
        conv3x3_per_step=per_step,
        fwd_flops_per_frame=work.dense_flops(cfg) + work.pfn_flops(
            float(np.mean([len(f["points"]) for f in frames])), cfg))
    if segment.after is not None:  # the untraced rest of a traced window
        run.readings.update(rest_s=t_end - segment.after[0],
                            rest_frames=n * batch - segment.after[1])
    if cuda:
        marks = [start_ev] + ends
        run.readings["step_ms"] = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        run.readings["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    finite = torch.isfinite(torch.stack(losses)).cpu()
    run.attempted, run.failed = n, int((~finite).sum())
    run.log(f"window {window:.3f} s, {n} steps")
    if segment.after is not None:
        run.readings["trace"] = segment.reduce(run.workdir / "trace.json", run.readings["rest_s"],
                                               n - segment.steps)

    del state, opt, model, step, batches, ds, logs, b
    if cuda:
        torch.cuda.empty_cache()
    del w0
    check(run, frames, shapes, params, losses0, grad1, delta3, total_steps)


def _dataset_seed(seed: int) -> int:
    return int(seed) % 2**32


def _shuffle_seed(seed: int) -> int:
    return (int(seed) // 2**32 + 7919 * int(seed)) % 2**32


def leaf_gaps(prog: dict, ref: dict, keep) -> dict:
    """Each leaf's |prog - ref| against the larger of its reference value and the
    median leaf's (norms of leaves)."""
    med = float(np.median([ref[k] for k in keep]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep}


def direction_gaps(prog: dict, ref: dict, keep) -> dict:
    """Each leaf's ||prog - ref|| against the larger of ||ref|| and the median leaf's
    (tensors of leaves): unlike ``leaf_gaps`` of their norms, it sees an update with
    the wrong direction, as AdamW's first, sign-like steps have about the same norm
    whatever their direction."""
    norms = {k: float(ref[k].norm()) for k in keep}
    med = float(np.median(list(norms.values())))
    return {k: float((prog[k] - ref[k]).norm()) / max(norms[k], med) for k in keep}


def worst(gaps: dict, run, name: str) -> float:
    top = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
    run.log(f"{name}: worst leaves " + ", ".join(f"{k} {v:.3e}" for k, v in top))
    return top[0][1]


def check(run, frames, shapes, params, losses0, grad1, delta3, total_steps):
    """The reference's first three steps against the program's."""
    cfg, dev = run.config, run.device
    common.set_tf32(False)
    t = time.perf_counter()
    batch = int(cfg["data"]["samples_per_gpu"])
    pool = [dict(points=waymo_raycast.loader_points(f), gt_boxes=f["gt_boxes"],
                 gt_names=f["gt_names"]) for f in frames]
    repeats = int(run.traffic["repeats"])
    batches = ref_data.train_batches(pool * repeats, cfg, batch, _shuffle_seed(run.seed),
                                     _dataset_seed(run.seed), COMPARED)
    n_cls = int(cfg["tasks"][-1]["num_class"])
    w = common.make_weights(shapes, lambda k, s: ref_models.param_fan_in(k, s, cfg), run.seed,
                            dev, n_cls, float(run.cell["weights"]["hm_bias"]))
    steps = ref_optim.reference_steps(w, params, batches, cfg, total_steps, dev)
    r_losses, r_grad1, r_after3 = steps["losses"], steps["grad1"], steps["after3"]
    after3 = {k: float(d.norm()) for k, d in delta3.items()}
    run.log("losses program " + ", ".join(f"{v:.7f}" for v in losses0) + "; reference "
            + ", ".join(f"{v:.7f}" for v in r_losses))
    med_g = float(np.median([r_grad1[k] for k in params]))
    moved = [k for k in params if r_grad1[k] >= 1e-3 * med_g]
    g = leaf_gaps(grad1, r_grad1, params)
    gaps = {
        "loss1_gap": abs(losses0[0] - r_losses[0]) / abs(r_losses[0]),
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses0, r_losses)),
        "grad_gap": worst(g, run, "grad_gap"),
        "grad_median_gap": float(np.median(list(g.values()))),
        "update_gap": worst(leaf_gaps(after3, r_after3, moved), run, "update_gap"),
    }
    d = direction_gaps(delta3, steps["delta"], moved)
    gaps["update_dir_gap"] = worst(d, run, "update_dir_gap")
    gaps["update_dir_median_gap"] = float(np.median(list(d.values())))
    if any(not math.isfinite(v) for v in gaps.values()):
        gaps = {k: (v if math.isfinite(v) else float("inf")) for k, v in gaps.items()}
    limits = run.cell["checks"]
    run.checks = {k: (v, float(limits[k])) for k, v in gaps.items() if k in limits}
    run.log("numbers not compared: " + ", ".join(f"{k} {v!r}" for k, v in gaps.items()
                                                 if k not in limits))
    run.readings["reference_s"] = time.perf_counter() - t
    run.log(f"reference {run.readings['reference_s']:.1f} s; {len(params) - len(moved)} "
            f"leaves left out of update_gap (gradient under 1e-3 of the median leaf's)")
