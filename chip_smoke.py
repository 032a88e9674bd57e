"""Smoke run of the PyTorch/H100 port (``tdal_torch``) on one CUDA card.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA card and
the CUDA toolkit (it builds the kernels from ``tdal_torch/ops/csrc``), imports
nothing of JAX or of ``tdal``, and exits non-zero on any failure. Phases:

1. the device: torch's name for it and nvidia-smi's name and power limit;
   TF32 off for every reference product;
2. the kernels' build, timed;
3. K1 (``fused_seg_encoder``) and K2 (``fused_seg_decoder``) against their plain
   twins at the labelers' production shapes (static B=64 N=4096 Cin=3, dynamic
   B=64 N=5120 Cin=4), in both operand modes, with kernel and twin times (CUDA
   events, warm, median of 20 launches) and each kernel's bound. Each mode's error
   is also held against the mode gap (the other mode's kernel against this mode's
   twin), so a kernel that ignored the operand mode fails;
4. stages 2-6 end to end on a synthetic segment (20 frames, 10 static + 10
   dynamic objects, 30000 background points, 256 points per object) with
   detections fabricated from its GT and fresh-init labelers from a seeded
   ``torch.Generator``: one warm pass, then a timed pass with the launch counters
   set to 0 just before it and read just after. Both labelers must label boxes and
   each kernel must run once per predict batch. One batch of each labeler is then
   held against the same model on the CPU (plain layers, no kernel);
5. one line ``{"kernels": [...]}``;
6. the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import logging
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit)
PEAK_FLOPS = {False: 67e12, True: 989e12}  # f32 on the CUDA cores; bf16 operands
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

ENC_WIDTHS = (64, 64, 64, 128, 1024)
DEC_WIDTHS = (512, 256, 128, 128, 2)


def log(msg: str):
    print(msg, flush=True)


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
    from tdal_torch.pipeline.factories import random_pointnet_seg

    results = {"fused_seg_encoder": {}, "fused_seg_decoder": {}}
    failures = []
    for shape_name, (b, n, cin) in SHAPES.items():
        seg = random_pointnet_seg(cin, seed=cin).to(device)
        x = torch.randn(b, n, cin, generator=torch.Generator().manual_seed(n)).to(device)
        with torch.inference_mode():
            folded = fp.fold_pointnet_seg_params(seg)
            enc_w, enc_b, dec = folded[0], folded[1], folded[2:]
            enc = {m: fp.fused_seg_encoder(x, enc_w, enc_b, m) for m in (False, True)}
            for bf16 in (False, True):
                mode = "bf16" if bf16 else "f32"
                skip, gmax = enc[bf16]
                logits = {m: fp.fused_seg_decoder(skip, gmax, *dec, m) for m in (False, True)}
                torch.cuda.synchronize()
                skip_t, gmax_t = fp.fused_seg_encoder_plain(x, enc_w, enc_b, bf16)
                logits_t = fp.fused_seg_decoder_plain(skip, gmax, *dec, bf16)
                checks = {
                    "fused_seg_encoder": (compare(enc[bf16], enc[not bf16], (skip_t, gmax_t)),
                                          lambda: fp.fused_seg_encoder(x, enc_w, enc_b, bf16),
                                          lambda: fp.fused_seg_encoder_plain(x, enc_w, enc_b, bf16),
                                          encoder_work(b, n, cin)),
                    "fused_seg_decoder": (compare([logits[bf16]], [logits[not bf16]], [logits_t]),
                                          lambda: fp.fused_seg_decoder(skip, gmax, *dec, bf16),
                                          lambda: fp.fused_seg_decoder_plain(skip, gmax, *dec, bf16),
                                          decoder_work(b, n)),
                }
                del skip_t, gmax_t, logits_t, logits
                for name, (err, kernel, plain, work) in checks.items():
                    ms, plain_ms = time_ms(kernel), time_ms(plain)
                    bound_ms, bound_by = bound(work, bf16)
                    r = dict(**err, tol=TOL[bf16], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, gflop=work[0] / 1e9, tflops=work[0] / ms / 1e9)
                    results[name][f"{shape_name} {mode}"] = r
                    log(f"  {name} {shape_name} B={b} N={n} Cin={cin} {mode}: "
                        f"max abs err {err['max_abs_err']:.3e}, rel {err['max_rel_err']:.3e} "
                        f"(tol {TOL[bf16]:.0e}), RMS {err['rms_err']:.3e}; the other mode's "
                        f"kernel against this twin: rel {err['gap_max_rel']:.3e}, "
                        f"RMS {err['gap_rms']:.3e}; kernel {ms:.3f} ms "
                        f"({r['tflops']:.1f} TFLOP/s), twin {plain_ms:.3f} ms, "
                        f"bound {bound_ms:.3f} ms ({bound_by})")
                    if not (err["max_rel_err"] <= TOL[bf16]
                            and MODE_MARGIN * err["rms_err"] <= err["gap_rms"]):
                        failures.append(f"{name} {shape_name} {mode}: {json.dumps(err)}")
        del seg, x, enc
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


def run_chain(out: Path, seg, labelers, logger) -> dict:
    """Stages 2-6 through the port's entry points, on the default device (CUDA)."""
    from tdal_torch.data.track_datasets import (
        DynamicTrackDataset, StaticTrackDataset, preprocess_tracks,
    )
    from tdal_torch.pipeline.labeler_run import (
        build_token2idx, postprocess_dynamic, postprocess_static, predict_final_boxes,
        sort_detections,
    )
    from tdal_torch.pipeline.motion_state import (
        build_track_gt, fit_motion_classifier, split_by_prediction, track_features,
    )
    from tdal_torch.pipeline.track_extraction import (
        convert_detection_to_global_box, create_pd_detection, reorganize, run_tracking,
    )

    infos, info_map, annos, detections, det_annos = seg
    det_annos = sort_detections([dict(d, boxes_lidar=d["boxes_lidar"].copy()) for d in det_annos])
    token2idx = build_token2idx(info_map, annos, det_annos)
    (s_model, s_inputs, s_kind), (d_model, d_inputs, d_kind) = labelers
    stage_s, counts, boxes = {}, {}, {}

    t0 = time.perf_counter()
    global_preds, det_results = convert_detection_to_global_box(detections, info_map, annos)
    predictions, _ = run_tracking(global_preds, det_results, score_thresh=0.1)
    stage_s["track"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    _, frame_track = create_pd_detection(predictions, info_map, out, tracking=True)
    track = reorganize(frame_track)
    stage_s["extract"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    X, y, new_track = track_features(track, build_track_gt(infos))
    clf = fit_motion_classifier(X, y)
    track_static, track_dynamic = split_by_prediction(new_track, clf.predict(X) if len(X) else [])
    stage_s["motion"] = time.perf_counter() - t0
    counts.update(tracks=len(new_track), static_tracks=len(track_static),
                  dynamic_tracks=len(track_dynamic))

    t0 = time.perf_counter()
    ts, _ = preprocess_tracks(track_static, annos, ratio=0.0, seed=0)
    s_ds = StaticTrackDataset(ts, annos, npoints=NPOINTS_STATIC, seed=0)
    boxes["static"] = predict_final_boxes(s_model, s_ds, s_inputs, s_kind, PREDICT_BATCH)
    counts["static_metrics"] = postprocess_static(ts, annos, boxes["static"], logger,
                                                  det_annos, token2idx)
    stage_s["static_label"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    d_ds = DynamicTrackDataset(track_dynamic, annos, npoints=NPOINTS_DYNAMIC, seed=0)
    boxes["dynamic"] = predict_final_boxes(d_model, d_ds, d_inputs, d_kind, PREDICT_BATCH)
    counts["dynamic_metrics"] = postprocess_dynamic(track_dynamic, annos, boxes["dynamic"],
                                                    logger, det_annos, token2idx)
    stage_s["dynamic_label"] = time.perf_counter() - t0

    counts["static_boxes_labeled"] = len(boxes["static"])
    counts["dynamic_boxes_labeled"] = len(boxes["dynamic"])
    counts["predict_batches"] = sum(math.ceil(len(ds) / PREDICT_BATCH) for ds in (s_ds, d_ds))
    datasets = {
        "static": lambda: StaticTrackDataset(ts, annos, npoints=NPOINTS_STATIC, seed=0),
        "dynamic": lambda: DynamicTrackDataset(track_dynamic, annos, npoints=NPOINTS_DYNAMIC,
                                               seed=0),
    }
    return dict(stage_s=stage_s, counts=counts, boxes=boxes, datasets=datasets)


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
    from tdal_torch.ops import fused_pointnet as fp
    from tdal_torch.pipeline.factories import make_labeler

    logger = logging.getLogger("chip_smoke")
    labelers = (make_labeler("one_box_est", seed=0), make_labeler("dynamic", seed=1))
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        seg = build_segment(root)
        log(f"  segment written and detections fabricated in {time.perf_counter() - t0:.2f} s")
        run_chain(root / "warm", seg, labelers, logger)
        torch.cuda.synchronize()

        for k in fp.launches:
            fp.launches[k] = 0
        t0 = time.perf_counter()
        res = run_chain(root / "timed", seg, labelers, logger)
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
                        res["datasets"]["static"], device)
        reference_check("dynamic labeler", d_model, d_inputs, d_kind,
                        res["datasets"]["dynamic"], device)
    return dict(launches=launches, total_s=total, **res["counts"], stage_s=res["stage_s"])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    from tdal_torch.ops import fused_pointnet as fp
    from tdal_torch.ops.build import kernels

    # phase 1: the device
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

    log("phase 2 build")
    t0 = time.perf_counter()
    kernels()
    log(f"  built the kernels with nvcc in {time.perf_counter() - t0:.1f} s")

    log("phase 3 kernels against their twins")
    kres = phase_kernels(device)
    log(f"  launches in phase 3 (checks and timing, not counted below): {dict(fp.launches)}")

    log("phase 4 stages 2-6 end to end")
    chain = phase_chain(device)

    entries = []
    for name, by_case in kres.items():
        main_case = by_case["static f32"]  # the main path's mode, at the static labeler's shape
        entries.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=chain["launches"][name], max_abs_err=main_case["max_abs_err"],
            ms=main_case["ms"], plain_ms=main_case["plain_ms"], bound_ms=main_case["bound_ms"],
            bound_by=main_case["bound_by"], library_ms=None,
            shape="static B=64 N=4096 Cin=3, f32 operands", cases=by_case,
        ))
    log(f"card: {kind} | {smi}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
