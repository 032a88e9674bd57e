"""Mode ``detect_two_stage``: the two-stage detector over a two-sweep corpus, as
``dist_test`` builds it and ``run_two_stage_inference`` composes it.

Set-up makes the pool of two-sweep frames from the seed (``traffic/waymo_sweeps.py``),
writes each frame and its previous sweep where the port's ``DetectionDataset`` reads
them (``nsweeps`` from the configuration, test mode), builds the engine with
``build_two_stage_engine`` as ``dist_test`` does, loads the benchmark's weights and
warms it on the pool's first batches. The window then runs ``detection_batches`` over
the pool, repeated and in order, -> ``make_two_stage_steps(engine)[1]`` (the first
stage's eval forward, decode and NMS, the five-point BEV gather, the RoI head and the
sqrt rescoring) -> ``predictions_to_host``, batch after batch, until ``--seconds`` have
passed on the host's clock; the batch under way is finished. ``detect_frames_per_s``
is the frames whose boxes reached the host over that time.

The weights are the seed's draws with BatchNorms as initialised; the last layers are
scaled as the cell's ``weights`` say (``reference/two_stage.calibrate``): the first
stage's head branches as in mode ``detect`` and its heatmap's bias so that greedy NMS
keeps the cell's ``kept_per_frame`` boxes a frame over the pool (the boxes a frame set
the NMS's host rounds, and so the pace: a share of the first batch's cells passing, as
mode ``detect`` sets it, kept 67-139 a frame from seed to seed), the RoI head's IoU and
residual outputs so that its scores spread and its boxes move by a share of their size.

With ``--trace 1``, CUDA events in forward hooks on the first stage's middle backbone
time it every batch, and the first ``trace_steps`` batches run under
``torch.profiler`` (``common.Segment``); the kernels launched inside the program's
``two_stage.*`` spans give the second stage's device time.

After the window the program is freed and the plain reference
(``reference/two_stage.py``) computes every pool frame's first-stage candidates (every
BEV cell's box) and runs its second stage on each. Each answer is matched to the
candidate of its label whose refined box and rescored score are nearest; the matched
set is held to greedy NMS's guarantees on the candidates' first-stage boxes and scores
(``reference/judge.py``: ``nms_violations``), and each answer to its candidate's
second-stage result: ``refine_gap`` (the refined box, velocity included, relative as
``box_gap`` is) and ``rescore_gap`` (the rescored score).
"""

from __future__ import annotations

import bisect
import itertools
import json
import os
import time

import numpy as np
import torch

from portbench import common, controls
from portbench.counts import two_stage as counts
from portbench.counts import work
from portbench.modes.detect import _occupancy
from portbench.reference import two_stage as ref
from portbench.reference.data import pad_points
from portbench.traffic import waymo_sweeps

_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def run(run, t_start: float):
    from tdal_torch.data.detection import DetectionDataset
    from tdal_torch.models.builder import (
        build_assigner, build_detector, build_test_cfg, build_two_stage_engine,
        build_voxel_config,
    )
    from tdal_torch.pipeline.detector_engine import predictions_to_host
    from tdal_torch.pipeline.detector_run import detection_batches
    from tdal_torch.pipeline.two_stage_engine import make_two_stage_steps
    from tdal_torch.runtime.train_state import TrainState

    cfg, p, dev = run.config, run.traffic, run.device
    cuda = dev.type == "cuda"
    common.set_tf32(False)  # the configuration states float32
    common.set_cudnn_benchmark(bool(run.cell["cudnn_benchmark"]))  # for the whole process
    batch = int(cfg["data"]["samples_per_gpu"])
    data = cfg["data"]["val"]
    run.phase(t_start, "program imported")
    frames = waymo_sweeps.make_pool(run.seed, p, dev)
    merged = [ref.merged_points(f) for f in frames]
    sizes = [len(m) for m in merged]
    run.log(f"points a frame, two sweeps merged: {min(sizes)}-{max(sizes)} "
            f"(cap {data['max_points']})")
    levels = _occupancy(run, [{"points": m} for m in merged])
    n_pool = len(frames)
    infos = waymo_sweeps.write_pool(frames, run.workdir / "pool")
    repeats = int(p["repeats"])
    infos = [dict(info, token=f"{r}_{info['token']}") for r in range(repeats) for info in infos]
    frame_of = {info["token"]: i % n_pool for i, info in enumerate(infos)}
    run.phase(t_start, "frames made and written")

    vox = build_voxel_config(cfg["voxel_generator"], train=False)
    first = build_detector(cfg["model"]["first_stage_cfg"], vox, device="cpu")
    engine = build_two_stage_engine(cfg["model"], vox, build_test_cfg(cfg["test_cfg"], first, vox),
                                    device=dev)
    del first
    shapes = {k: tuple(v.shape) for k, v in engine.state_dict().items()}
    w = engine_weights(run, shapes, frames, merged)
    engine.load_state_dict(w)
    weights = {k: v.cpu() for k, v in w.items()}  # the reference's, off the device
    del w
    if cuda:  # the peak is the program's (not the calibration's): set-up batches and window
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    engine.eval()
    common.set_tf32(controls.tf32_on(run))  # on only under the control
    ds = DetectionDataset(infos, cfg["class_names"], build_assigner(cfg["assigner"], engine.first),
                          vox, mode="test", nsweeps=int(data["nsweeps"]),
                          max_points=int(data["max_points"]))
    state = TrainState(engine, None)
    step = make_two_stage_steps(engine)[1]
    batches = (b for _ in itertools.count() for b in detection_batches(ds, batch, shuffle=False))
    run.phase(t_start, "engine and data built")

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
        backbone = engine.first.backbone
        hooks = [backbone.register_forward_pre_hook(mark("in")),
                 backbone.register_forward_hook(mark("out"))]
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
        pending = None
        run.readings["backbone_ms"] = []
        for tag, ev in marks:
            if tag == "in":
                pending = ev
            elif pending is not None:
                run.readings["backbone_ms"].append(pending.elapsed_time(ev))
                pending = None
    batch_ms = np.diff([t0] + ends) * 1e3
    run.log(f"window {window:.3f} s, {n_frames} frames in {n_batches} batches; ms a batch "
            f"min {batch_ms.min():.1f}, median {np.median(batch_ms):.1f}, max {batch_ms.max():.1f}")
    if segment.after is not None:
        # a profiler exports its trace once: keep a link to the file ``reduce`` writes
        kept = run.workdir / "trace_spans.json"
        export = segment.prof.export_chrome_trace

        def export_and_keep(path):
            export(path)
            os.link(path, kept)

        segment.prof.export_chrome_trace = export_and_keep
        run.readings["trace"] = segment.reduce(run.workdir / "trace.json",
                                               t_end - segment.after[0], n_batches - segment.steps)
        run.readings["second_stage_ms"] = span_kernels_ms(kept, "two_stage.", segment.steps)
        kept.unlink()

    # the counts of this window's frames
    per_frame = counts.dense_flops(cfg) + counts.second_stage_flops(cfg)
    cin = int(cfg["model"]["first_stage_cfg"]["backbone"]["num_input_features"])
    sparse = [counts.sparse_convs(lv, cin) for lv in levels]
    done = [frame_of[t] for toks, _ in answers for t in toks]
    rest = done[segment.after[1]:] if segment.after is not None else done
    run.readings["model_flops"] = sum(per_frame + sum(c[2] for c in sparse[f]) for f in rest)
    run.readings["model_flops_s"] = t_end - segment.after[0] if segment.after else window
    run.readings["sparse_least_s"] = sum(
        sum(work.least_seconds(c[2], c[3])[0] for c in sparse[f]) for f in done)

    del state, engine, step, batches, ds
    if cuda:
        torch.cuda.empty_cache()
    check(run, merged, answers, frame_of, weights)


def span_kernels_ms(path, prefix: str, steps: int):
    """The device ms a unit of the kernels launched while a program span named
    ``prefix...`` was open, in a profiler's Chrome trace; None where it holds no such
    span or no such kernel."""
    events = json.loads(path.read_text())["traceEvents"]
    spans, calls, kernels = [], [], {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        corr = (e.get("args") or {}).get("correlation")
        if cat == "user_annotation" and name.startswith(prefix):
            spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        elif cat in ("cuda_runtime", "cuda_driver") and name in _LAUNCHES:
            calls.append((float(e["ts"]), corr))
        elif cat == "kernel":
            kernels[corr] = kernels.get(corr, 0.0) + float(e["dur"])
    if not spans:
        return None
    spans.sort()
    starts = [a for a, _ in spans]
    total, found = 0.0, False
    for ts, corr in calls:
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts <= spans[i][1] and corr in kernels:
            total += kernels[corr]
            found = True
    return total / 1e3 / steps if found else None


def engine_weights(run, shapes, frames, merged) -> dict:
    """The benchmark's engine from the seed: lecun-normal weights, BatchNorms as
    initialised (running mean 0, variance 1), the last layers scaled as the cell's
    ``weights`` say on the pool, in batches by scene, the spreads on its first scenes
    (``reference.calibrate``)."""
    cfg, dev = run.config, run.device
    spec = run.cell["weights"]
    tasks = cfg["model"]["first_stage_cfg"]["bbox_head"]["tasks"]
    w = common.make_weights(shapes, lambda k, s: ref.param_fan_in(k, s, cfg), run.seed, dev,
                            int(tasks[-1]["num_class"]))
    batch = int(cfg["data"]["samples_per_gpu"])
    scenes = sorted(range(len(frames)), key=lambda i: frames[i]["scene"])
    batches = [_padded([merged[i] for i in scenes[j : j + batch]], cfg, dev)
               for j in range(0, len(scenes), batch)]
    return ref.calibrate(w, batches, cfg, spec["head_spread"], float(spec["kept_per_frame"]),
                         float(spec["iou_pass"]), float(spec["reg_share"]))


def _padded(merged, cfg, dev):
    n = int(cfg["data"]["val"]["max_points"])
    return torch.as_tensor(np.stack([pad_points(m, n) for m in merged]), device=dev)


def check(run, merged, answers, frame_of, weights):
    """Every answer of the window against the reference's two stages on its frame, with
    the weights the program ran."""
    cfg, dev = run.config, run.device
    common.set_tf32(False)
    t = time.perf_counter()
    test_cfg = cfg["test_cfg"]
    w = {k: v.to(dev) for k, v in weights.items()}
    batch = int(cfg["data"]["samples_per_gpu"])
    cands = []
    with torch.no_grad():
        for i in range(0, len(merged), batch):
            maps, bev = ref.first_stage(_padded(merged[i : i + batch], cfg, dev), w, cfg)
            boxes, scores = ref.decode(maps[0], test_cfg)
            for j in range(len(boxes)):
                best = scores[j].max(-1).values
                refined, rescored, _ = ref.second_stage(bev[j], boxes[j], best, w, cfg)
                cands.append((boxes[j], scores[j], refined, rescored))
    del w
    limits, margins = run.cell["checks"], run.cell["nms_margins"]
    seen, kept = {}, []
    worst = dict(refine_gap=0.0, rescore_gap=0.0, violations=0)
    worst_at = ""
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
                seen[key] = ref.judge_frame(*cands[f], a, test_cfg, float(margins["score"]),
                                            float(margins["iou"]))
                for d in seen[key]["detail"]:
                    run.log(f"frame {f}: {d}")
            r = seen[key]
            kept.append(r["kept"])
            if r["refine_gap"] > worst["refine_gap"]:
                worst_at = f"frame {f}: {r['refine_at']}"
            worst["refine_gap"] = max(worst["refine_gap"], r["refine_gap"])
            worst["rescore_gap"] = max(worst["rescore_gap"], r["rescore_gap"])
            worst["violations"] += r["violations"]
    run.readings["kept_per_frame"] = float(np.mean(kept)) if kept else 0.0
    run.checks = {"nms_violations": (float(worst["violations"]), 0.0),
                  "refine_gap": (worst["refine_gap"], float(limits["refine_gap"])),
                  "rescore_gap": (worst["rescore_gap"], float(limits["rescore_gap"]))}
    run.log(f"largest refine_gap {worst['refine_gap']!r} at {worst_at}")
    run.readings["reference_s"] = time.perf_counter() - t
    run.log(f"reference {run.readings['reference_s']:.1f} s; {len(seen)} distinct answers "
            f"judged, {run.readings['kept_per_frame']:.1f} boxes kept a frame")
