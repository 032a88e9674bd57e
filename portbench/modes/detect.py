"""Mode ``detect``: a pass of the detector over a corpus, as ``run_inference`` composes it.

Set-up makes the frame pool from the seed, writes it where the port's
``DetectionDataset`` reads it (test mode, the configuration's test settings), builds
the detector in eval mode with the benchmark's weights and warms it on the pool's
first batches. The window then runs ``detection_batches`` over the pool, repeated and
in order, -> ``make_predict_step`` (the eval forward, decode and NMS) ->
``predictions_to_host``, batch after batch, until ``--seconds`` have passed on the
host's clock; the batch under way is finished (its boxes reach the host).
``detect_frames_per_s`` is the frames whose boxes reached the host over that time.

The weights are the seed's draws, their BatchNorms as initialised; each head branch's
final conv is scaled so that its outputs spread as the cell's ``weights`` say, and the
heatmap's bias shifted so that the share of BEV cells the cell names passes the score
threshold, so that the scores spread and about as many boxes a frame are kept as a
trained detector keeps. (Running statistics taken from the
data instead make the eval forward of a random deep network chaotic: rounding then
grows into different boxes.)

With ``--trace 1``, CUDA events in forward hooks on the model and on its middle
backbone time the backbone and the decode + NMS of every batch, and the first ``trace_steps`` batches run
under ``torch.profiler`` (``common.Segment``).

Once the window has closed and the peak memory is read, the program is freed; the
plain reference (``portbench/reference``) computes every pool frame's maps from the
same weights and points, and every answer of the window is judged against them
(``portbench/reference/judge.py``).
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from portbench import common, controls
from portbench.counts import work
from portbench.reference import judge as ref_judge
from portbench.reference import models as ref_models
from portbench.reference.data import pad_points
from portbench.traffic import waymo_raycast


def _occupancy(run, frames):
    """Each pool frame's sparse levels (coordinates, grid), logged against their caps."""
    cfg = run.config
    vg = cfg["voxel_generator"]
    v = min(int(vg["max_voxel_num"][1]), int(cfg["data"]["val"]["max_points"]))
    caps = (v, v // 2, v // 4, v // 8, v // 8)
    levels = [work.sparse_levels(f["points"], cfg, run.device) for f in frames]
    counts = np.array([[len(c) for _, c, _ in lv] for lv in levels])
    run.readings["occupancy"] = counts.tolist()
    names = [n for n, _, _ in levels[0]]
    run.log("occupied voxels per level (min-max over the pool, cap): " + "; ".join(
        f"{n} {counts[:, i].min()}-{counts[:, i].max()} of {caps[i]}"
        for i, n in enumerate(names)))
    if (counts >= np.array(caps)[None]).any():
        run.log("a sparse level reached its cap: the program drops voxels there")
    return levels


def run(run, t_start: float):
    from tdal_torch.data.detection import DetectionDataset
    from tdal_torch.models.builder import (
        build_assigner, build_detector, build_test_cfg, build_voxel_config,
    )
    from tdal_torch.pipeline.detector_engine import make_predict_step, predictions_to_host
    from tdal_torch.pipeline.detector_run import detection_batches
    from tdal_torch.runtime.train_state import TrainState

    cfg, p, dev = run.config, run.traffic, run.device
    cuda = dev.type == "cuda"
    common.set_tf32(False)  # the configurations state float32
    common.set_cudnn_benchmark(bool(run.cell["cudnn_benchmark"]))  # for the whole process
    batch = int(cfg["data"]["samples_per_gpu"])
    run.phase(t_start, "program imported")
    frames = waymo_raycast.make_pool(run.seed, p, dev)
    run.phase(t_start, "frames made")
    levels = _occupancy(run, frames)
    if cuda:  # the peak is the program's: set-up batches and window
        torch.cuda.reset_peak_memory_stats(dev)
    n_pool = len(frames)
    infos = waymo_raycast.write_pool(frames, run.workdir / "pool")
    repeats = int(p["repeats"])
    infos = [dict(info, token=f"{r}_{info['token']}") for r in range(repeats) for info in infos]
    frame_of = {info["token"]: i % n_pool for i, info in enumerate(infos)}
    run.phase(t_start, "frames made and written")

    vox = build_voxel_config(cfg["voxel_generator"], train=False)
    model = build_detector(cfg["model"], vox, device=dev)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    model.load_state_dict(detector_weights(run, shapes, frames))
    model.eval()
    common.set_tf32(controls.tf32_on(run))  # on only under the control
    test_cfg = build_test_cfg(cfg["test_cfg"], model, vox)
    ds = DetectionDataset(infos, cfg["class_names"], build_assigner(cfg["assigner"], model),
                          vox, mode="test", max_points=cfg["data"]["val"]["max_points"])
    state = TrainState(model, None)
    step = make_predict_step(model, test_cfg)
    batches = (b for _ in itertools.count() for b in detection_batches(ds, batch, shuffle=False))
    run.phase(t_start, "detector and data built")

    def predict(b):
        n = b["n_valid"]
        preds = step(state, torch.as_tensor(np.asarray(b["points"]), device=dev))
        return predictions_to_host(preds, b["token"][:n]), n

    for _ in range(int(p["warm_batches"]) - 1):
        predict(next(batches))
    with common.profiler_warmed(run):
        predict(next(batches))
    if cuda:
        torch.cuda.synchronize(dev)
    run.readings["setup_s"] = time.perf_counter() - t_start
    run.log(f"set-up {run.readings['setup_s']:.2f} s")

    hooks, marks = [], []
    if run.trace and cuda:
        def mark(tag):
            def hook(*_):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append((tag, ev))
            return hook
        hooks = [model.backbone.register_forward_pre_hook(mark("backbone_in")),
                 model.backbone.register_forward_hook(mark("backbone_out")),
                 model.register_forward_hook(mark("forward_out"))]
    if cuda:
        torch.cuda.synchronize(dev)
    answers, waits, ends, n_frames, n_batches = [], [], [], 0, 0
    segment = common.Segment(run, int(p["trace_steps"]))
    t0 = time.perf_counter()
    segment.start(t0)
    while True:
        tw = time.perf_counter()
        b = next(batches)
        waits.append(time.perf_counter() - tw)
        try:
            out, n = predict(b)
        except (RuntimeError, IndexError, ValueError) as e:
            run.log(f"the predict step failed: {e!r}")
            run.failed += b["n_valid"]
            run.attempted += b["n_valid"]
            break
        if run.trace and cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(("on_host", ev))
        answers.append((list(b["token"][:n]), out))
        n_frames += n
        n_batches += 1
        ends.append(time.perf_counter())
        segment.tick(n_batches, n_frames)
        if time.perf_counter() - t0 >= run.seconds and not segment.open:
            break
    t_end = time.perf_counter()
    window = t_end - t0
    for h in hooks:
        h.remove()
    run.attempted += n_frames
    run.readings.update(window_s=window, frames=n_frames, batches=n_batches, waits=waits)
    if cuda:
        torch.cuda.synchronize(dev)
        run.readings["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        _read_marks(run, marks)
    batch_ms = np.diff([t0] + ends) * 1e3
    run.log(f"window {window:.3f} s, {n_frames} frames in {n_batches} batches; ms a batch "
            f"min {batch_ms.min():.1f}, median {np.median(batch_ms):.1f}, max {batch_ms.max():.1f}")
    if segment.after is not None:
        run.readings["trace"] = segment.reduce(run.workdir / "trace.json",
                                               t_end - segment.after[0], n_batches - segment.steps)

    # the counts of this window's frames
    dense = work.dense_flops(cfg)
    sparse = [work.sparse_convs(lv) for lv in levels]
    done = [frame_of[t] for toks, _ in answers for t in toks]
    rest = done[segment.after[1]:] if segment.after is not None else done
    run.readings["model_flops"] = sum(dense + sum(c[2] for c in sparse[f]) for f in rest)
    run.readings["model_flops_s"] = t_end - segment.after[0] if segment.after else window
    run.readings["sparse_least_s"] = sum(
        sum(work.least_seconds(c[2], c[3])[0] for c in sparse[f]) for f in done)

    del state, model, step, batches, ds
    if cuda:
        torch.cuda.empty_cache()
    check(run, frames, answers, frame_of, shapes, test_cfg)


def detector_weights(run, shapes, frames) -> dict:
    """The benchmark's detector from the seed: lecun-normal weights, BatchNorms as
    initialised (running mean 0, variance 1), and each head branch's final conv scaled
    and the heatmap's bias shifted as the cell's ``weights`` say, on a batch of the
    pool's first scenes (``calibrate_head``, by the reference)."""
    cfg, dev = run.config, run.device
    spec = run.cell["weights"]
    w = common.make_weights(shapes, lambda k, s: ref_models.param_fan_in(k, s, cfg), run.seed,
                            dev, int(cfg["tasks"][-1]["num_class"]))
    batch = int(cfg["data"]["samples_per_gpu"])
    first = sorted(frames, key=lambda f: f["scene"])[:batch]  # the same scenes every seed
    return ref_models.calibrate_head(w, _padded(first, cfg, dev), cfg,
                                     spec["head_spread"], float(spec["hm_pass_share"]),
                                     float(cfg["test_cfg"]["score_threshold"]))


def _padded(frames, cfg, dev):
    max_points = int(cfg["data"]["val"]["max_points"])
    return torch.as_tensor(np.stack([pad_points(waymo_raycast.loader_points(f), max_points)
                                     for f in frames]), device=dev)


def _read_marks(run, marks):
    backbone, decode = [], []
    pending = {}
    for tag, ev in marks:
        if tag == "backbone_in":
            pending["in"] = ev
        elif tag == "backbone_out" and "in" in pending:
            backbone.append(pending.pop("in").elapsed_time(ev))
        elif tag == "forward_out":
            pending["fwd"] = ev
        elif tag == "on_host" and "fwd" in pending:
            decode.append(pending.pop("fwd").elapsed_time(ev))
    run.readings["backbone_ms"] = backbone
    run.readings["decode_nms_ms"] = decode


def check(run, frames, answers, frame_of, shapes, test_cfg):
    """Every answer of the window against the reference's maps of its frame."""
    cfg, dev = run.config, run.device
    common.set_tf32(False)
    t = time.perf_counter()
    w = detector_weights(run, shapes, frames)
    batch = int(cfg["data"]["samples_per_gpu"])
    decoded = []
    with torch.no_grad():
        for i in range(0, len(frames), batch):
            maps, _ = ref_models.voxelnet_eval(_padded(frames[i : i + batch], cfg, dev), w, cfg)
            boxes, scores = ref_models.decode(maps[0], test_cfg)
            decoded += [(boxes[j], scores[j]) for j in range(len(boxes))]
    del w
    limits = run.cell["checks"]
    score_eps = float(limits["score_gap"])
    iou_eps = 10 * float(limits["box_gap"])
    seen, worst = {}, dict(score_gap=0.0, box_gap=0.0, violations=0)
    kept = []
    for toks, out in answers:
        for tok in toks:
            f = frame_of[tok]
            a = out.get(tok)
            if a is None:
                worst["violations"] += 1
                continue
            key = (f, a["box3d_lidar"].tobytes(), a["scores"].tobytes(),
                   a["label_preds"].tobytes())
            if key not in seen:
                seen[key] = ref_judge.judge_frame(*decoded[f], a, test_cfg, score_eps, iou_eps)
                for d in seen[key]["detail"]:
                    run.log(f"frame {f}: {d}")
            r = seen[key]
            kept.append(r["kept"])
            worst["score_gap"] = max(worst["score_gap"], r["score_gap"])
            worst["box_gap"] = max(worst["box_gap"], r["box_gap"])
            worst["violations"] += r["violations"]
    run.readings["kept_per_frame"] = float(np.mean(kept)) if kept else 0.0
    run.checks = {"score_gap": (worst["score_gap"], float(limits["score_gap"])),
                  "box_gap": (worst["box_gap"], float(limits["box_gap"])),
                  "nms_violations": (float(worst["violations"]), 0.0)}
    run.readings["reference_s"] = time.perf_counter() - t
    run.log(f"reference {run.readings['reference_s']:.1f} s; {len(seen)} distinct answers "
            f"judged, {run.readings['kept_per_frame']:.1f} boxes kept a frame")
