"""Labeler stages 5-6: training, final-box prediction and postprocessing.

Port of ``tdal/pipeline/labeler_run.py``: ``train_labeler`` (:41-135: the epoch loop,
per-epoch eval, the best checkpoint by eval ``iou3d_acc_07``), ``decode_final_boxes_np``,
``predict_final_boxes``, ``sort_detections``, ``build_token2idx``,
``postprocess_static``, ``postprocess_dynamic`` and the no-learning baselines
``calculate_init_iou`` / ``calculate_static_iou`` (:343-389).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import torch

from tdal_torch.core.codecs import MEAN_SIZE_ARR
from tdal_torch.core.iou import labeler_box3d_iou
from tdal_torch.data.track_datasets import Prefetcher, batch_iterator, parallel_batch_iterator
from tdal_torch.data.waymo_schema import AnnoStore, box7_from_box9, transform_box_np
from tdal_torch.device import resolve_device
from tdal_torch.parallel.mesh import rank_step, start_run
from tdal_torch.pipeline.labeler_engine import average_metrics, make_steps
from tdal_torch.runtime.checkpoint import CheckpointManager
from tdal_torch.runtime.logging_utils import MetricsWriter
from tdal_torch.runtime.train_state import TrainState

VEHICLE_TYPE = 1
CYCLIST_TYPE = 4

_DECODE_KEYS = ("heading_scores", "heading_residuals", "size_scores", "size_residuals",
                "center", "box_one")


def train_labeler(model, loss_fn, inputs_fn, state: TrainState, train_ds, val_ds,
                  n_epoch: int, batch_size: int, logger, ckpt_dir=None, seed: int = 0,
                  generator: torch.Generator | None = None, num_workers: int = 0,
                  mesh=None):
    """Train ``state.model`` (``model``, on its device) for ``n_epoch`` epochs.

    Each epoch shuffles with numpy seed ``seed + epoch`` and drops the short last
    batch; the train steps' draws come from ``generator`` (a ``torch.Generator`` on the
    model's device; None makes one seeded with ``seed``). After each epoch the model
    is evaluated on ``val_ds`` (batches padded to ``batch_size``); the best eval
    ``iou3d_acc_07`` (``>=``, so the later of equals) is saved under ``ckpt_dir``.
    Returns (state, best meta). Parity: static_train.py:149-165.

    With a data-parallel ``mesh`` ``batch_size`` is the global batch: every rank builds
    each batch whole and takes its rows, draws over the global batch (``train_draws``)
    and starts from rank 0's weights; the eval is sharded the same way, with its metrics
    over the global batch, so every rank makes the same best-checkpoint choice. Rank 0
    alone logs and writes the metrics and checkpoints."""
    device = next(model.parameters()).device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    main, logger = start_run(mesh, batch_size, model, logger)
    if not main:
        ckpt_dir = None
    train_step, eval_step = make_steps(model, loss_fn, inputs_fn)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir is not None else None
    writer = MetricsWriter(Path(ckpt_dir) / "logs") if ckpt_dir is not None else None
    best_acc, best_meta = -1.0, {}

    def on_rows(step, batch, *args):
        with rank_step(mesh, batch) as rows:
            return step(state, rows, *args)

    def run_eval():
        return average_metrics([on_rows(eval_step, batch)[0] for batch in
                                batch_iterator(val_ds, batch_size, pad_to_full=True)])

    for epoch in range(n_epoch):
        batches = parallel_batch_iterator(train_ds, batch_size, num_workers=num_workers,
                                          shuffle=True, seed=seed + epoch, drop_last=True)
        train_m = average_metrics([on_rows(train_step, batch, generator)
                                   for batch in Prefetcher(batches)])
        logger.info(f"=== Epoch [{epoch + 1}/{n_epoch}] ===")
        logger.info(f"[Train] loss: {train_m.get('total_loss', float('nan')):.4f}, "
                    f"seg acc: {train_m.get('seg_acc', float('nan')):.4f}")
        logger.info(f"[Train] Box IoU (2D/3D): {train_m.get('iou2d', 0):.4f}/"
                    f"{train_m.get('iou3d', 0):.4f}; acc@0.7: {train_m.get('iou3d_acc_07', 0):.4f}")
        eval_m = run_eval()
        if writer is not None:
            writer.write(state.step, train_m, mode="train")
            writer.write(state.step, eval_m, mode="val")
        logger.info(f"[Eval] loss: {eval_m.get('total_loss', float('nan')):.4f}, "
                    f"seg acc: {eval_m.get('seg_acc', float('nan')):.4f}")
        logger.info(f"[Eval] Box IoU (2D/3D): {eval_m.get('iou2d', 0):.4f}/"
                    f"{eval_m.get('iou3d', 0):.4f}; acc@0.7: {eval_m.get('iou3d_acc_07', 0):.4f}")
        acc = eval_m.get("iou3d_acc_07", 0.0)
        if acc >= best_acc:
            best_acc = acc
            best_meta = {"epoch": epoch + 1, "eval_iou3d_acc": acc, **eval_m}
            if mgr is not None:
                mgr.save(state.step, {"model": model.state_dict()}, meta=best_meta,
                         is_best=True)
    return state, best_meta


def decode_final_boxes_np(output, init_box: np.ndarray, kind: str) -> np.ndarray:
    """Decode a batch of model outputs (numpy) to (B, 7) boxes.

    kind: 'static_one' | 'static_two' | 'dynamic'. Parity:
    static_eval.test_one_epoch (:276-287) and dynamic_eval.test_one_epoch (:228-242)."""
    hs = np.asarray(output["heading_scores"])
    hr = np.asarray(output["heading_residuals"])
    ss = np.asarray(output["size_scores"])
    sr = np.asarray(output["size_residuals"])
    center = np.asarray(output["center"]).copy()
    b = hs.shape[0]
    h_cls = hs.argmax(1)
    h_res = hr[np.arange(b), h_cls]
    s_cls = ss.argmax(1)
    s_res = sr[np.arange(b), s_cls]
    angle_per = 2 * np.pi / 12
    heading = h_cls * angle_per + h_res
    heading = np.where(heading > np.pi, heading - 2 * np.pi, heading)
    size = MEAN_SIZE_ARR[s_cls] + s_res
    if kind == "static_one":
        heading = heading + init_box[:, 6]
    elif kind == "static_two":
        heading = heading + np.asarray(output["box_one"])[:, 6]
    elif kind == "dynamic":
        heading = heading + init_box[:, 6]
        center = center + init_box[:, :3]
    else:
        raise ValueError(kind)
    return np.concatenate([center, size, heading[:, None]], axis=1)


def predict_final_boxes(model, dataset, inputs_fn, kind: str, batch_size: int = 64,
                        device=None) -> np.ndarray:
    """Ordered inference over a dataset -> (len(dataset), 7) final boxes.

    ``model`` (a labeler ``nn.Module``) is moved to ``device`` (None means CUDA) and
    set to eval; batches are padded to ``batch_size`` as in tdal."""
    dev = resolve_device(device)
    model = model.to(dev).eval()
    boxes = []
    with torch.inference_mode():
        for batch in batch_iterator(dataset, batch_size, pad_to_full=True):
            n_valid = batch.pop("n_valid")
            inputs = [torch.as_tensor(np.asarray(x), device=dev) for x in inputs_fn(batch)]
            out = model(*inputs)
            host = {k: out[k].cpu().numpy() for k in _DECODE_KEYS if k in out}
            decoded = decode_final_boxes_np(host, np.asarray(batch["init_box"]), kind)
            boxes.append(decoded[:n_valid])
    return np.concatenate(boxes, axis=0) if boxes else np.zeros((0, 7))


def sort_detections(det_annos):
    """Sort det_annos by frame_id. Parity: static_eval.py:169-176."""
    order = np.argsort(np.array([d["frame_id"] for d in det_annos]))
    return [det_annos[i] for i in order]


def build_token2idx(infos: Dict[str, dict], annos: AnnoStore, det_annos) -> Dict[str, int]:
    """token -> det_annos index, via the frame_id naming convention
    (static_eval.py:326-334)."""
    annos2idx = {d["frame_id"]: i for i, d in enumerate(det_annos)}
    token2idx = {}
    for token in infos:
        a = annos.get(token)["annos"]
        fid = f"segment-{a['scene_name']}_with_camera_labels_{a['frame_id']:03d}"
        token2idx[token] = annos2idx[fid]
    return token2idx


def _relative_iou_metrics(pred_boxes, gt_boxes, init_headings, types, logger, tag, device):
    """Both headings taken relative to the init heading, corner IoU via
    ``labeler_box3d_iou`` (f32, on ``device``); acc@0.7 vehicles / @0.5 cyclists."""
    if len(pred_boxes) == 0:
        logger.info(f"[{tag}] no samples")
        return 0.0, 0.0, 0.0
    pred = np.asarray(pred_boxes, np.float64).copy()
    gt = np.asarray(gt_boxes, np.float64).copy()
    ih = np.asarray(init_headings, np.float64)
    types = np.asarray(types)

    def _rel(h, base):
        # angle2class -> class2angle roundtrip: mod 2pi then shift to (-pi, pi]
        a = (h - base) % (2 * np.pi)
        return np.where(a > np.pi, a - 2 * np.pi, a)

    pred[:, 6] = _rel(pred[:, 6], ih)
    gt[:, 6] = _rel(gt[:, 6], ih)
    iou3d, iou2d = labeler_box3d_iou(
        torch.as_tensor(pred, dtype=torch.float32, device=device),
        torch.as_tensor(gt, dtype=torch.float32, device=device),
    )
    iou3d, iou2d = iou3d.cpu().numpy(), iou2d.cpu().numpy()
    thresh = np.where(types == CYCLIST_TYPE, 0.5, 0.7)
    acc = (iou3d >= thresh).astype(np.float64)
    m2, m3, ma = float(iou2d.mean()), float(iou3d.mean()), float(acc.mean())
    logger.info(f"[{tag}] Box IoU (2D/3D): {m2:.4f}/{m3:.4f}")
    logger.info(f"[{tag}] Box estimation accuracy: {ma:.4f}")
    return m2, m3, ma


def _patch_det_annos(det_annos, token2idx, token, frame_box, new_box):
    """Overwrite the det_annos row whose center is within 0.1m of frame_box
    (static_eval.py:148-155). Returns True when patched."""
    if token2idx is None or det_annos is None:
        return False
    rows = det_annos[token2idx[token]]["boxes_lidar"]
    d = np.linalg.norm(rows[:, :3] - frame_box[:3], axis=1)
    k = int(np.argmin(d)) if len(d) else -1
    if k >= 0 and d[k] < 0.1:
        rows[k, :] = new_box
        return True
    return False


def postprocess_static(track, annos: AnnoStore, final_bboxes, logger, det_annos=None,
                       token2idx=None, device=None):
    """Broadcast each track's refined box to all its frames; metrics + patching.

    Parity: static_eval.postprocessing (static_eval.py:62-167). final_bboxes (T, 7)
    are in each track's best-score frame vehicle coords."""
    dev = resolve_device(device)
    preds, gts, inits, types = [], [], [], []
    n_patched = 0
    for i, (key, value) in enumerate(track.items()):
        score = np.stack(value["score"])
        tokens = value["token"]
        best = int(np.argmax(score))
        pose_best = annos.pose(tokens[best])  # best-frame vehicle -> global
        final_global = transform_box_np(final_bboxes[None, i], pose_best)[0]
        best_box_global = np.asarray(value["bbox"][best], np.float64)
        for j, t in enumerate(tokens):
            inv = annos.inv_pose(t)
            frame_box = transform_box_np(
                np.asarray(value["bbox"][j], np.float64)[None], inv
            )[0]
            final_f = transform_box_np(final_global[None], inv)[0]
            init_f = transform_box_np(best_box_global[None], inv)[0]
            obj = annos.find_object(t, value["match"][-1])
            n_patched += _patch_det_annos(det_annos, token2idx, t, frame_box, final_f)
            if obj is None:
                continue
            preds.append(final_f)
            gts.append(box7_from_box9(np.asarray(obj["box"], np.float64)))
            inits.append(init_f[6])
            types.append(value["type"][j])
    metrics = _relative_iou_metrics(preds, gts, inits, types, logger, "Eval", dev)
    if det_annos is not None:
        logger.info(f"patched {n_patched} det_annos rows")
    return metrics


def postprocess_dynamic(track, annos: AnnoStore, final_bboxes, logger, det_annos=None,
                        token2idx=None, device=None):
    """Per-frame refined boxes (already in each frame's vehicle coords); metrics +
    patching. Parity: dynamic_eval.postprocessing (dynamic_eval.py:43-141); headings
    are absolute in frame coords."""
    dev = resolve_device(device)
    preds, gts, types = [], [], []
    n_patched = 0
    index = 0
    for key, value in track.items():
        tokens = value["token"]
        for j, t in enumerate(tokens):
            inv = annos.inv_pose(t)
            frame_box = transform_box_np(
                np.asarray(value["bbox"][j], np.float64)[None], inv
            )[0]
            final_f = final_bboxes[index + j]
            obj = annos.find_object(t, value["match"][-1])
            n_patched += _patch_det_annos(det_annos, token2idx, t, frame_box, final_f)
            if obj is None:
                continue
            preds.append(final_f)
            gts.append(box7_from_box9(np.asarray(obj["box"], np.float64)))
            types.append(value["type"][j])
        index += len(tokens)
    metrics = _relative_iou_metrics(
        preds, gts, np.zeros(len(preds)), types, logger, "Eval", dev
    )
    if det_annos is not None:
        logger.info(f"patched {n_patched} det_annos rows")
    return metrics


def calculate_init_iou(track, annos: AnnoStore, logger, device=None):
    """No-learning baseline 1: the raw per-frame detection boxes against the GT.

    Parity: static_init.calculate_init_iou (static_init.py:58-141)."""
    dev = resolve_device(device)
    preds, gts, inits, types = [], [], [], []
    for key, value in track.items():
        for j, t in enumerate(value["token"]):
            inv = annos.inv_pose(t)
            init_f = transform_box_np(np.asarray(value["bbox"][j], np.float64)[None], inv)[0]
            obj = annos.find_object(t, value["match"][-1])
            if obj is None:
                continue
            preds.append(init_f)
            gts.append(box7_from_box9(np.asarray(obj["box"], np.float64)))
            inits.append(init_f[6])
            types.append(value["type"][j])
    return _relative_iou_metrics(preds, gts, inits, types, logger, "Init", dev)


def calculate_static_iou(track, annos: AnnoStore, logger, det_annos=None, token2idx=None,
                         device=None):
    """No-learning baseline 2: each track's best-score box in every one of its frames,
    with the det_annos rows patched. Parity: static_init.calculate_static_iou
    (static_init.py:143-241)."""
    dev = resolve_device(device)
    preds, gts, inits, types = [], [], [], []
    n_patched = 0
    for key, value in track.items():
        best = int(np.argmax(np.stack(value["score"])))
        best_box_global = np.asarray(value["bbox"][best], np.float64)
        for j, t in enumerate(value["token"]):
            inv = annos.inv_pose(t)
            frame_box = transform_box_np(np.asarray(value["bbox"][j], np.float64)[None], inv)[0]
            static_f = transform_box_np(best_box_global[None], inv)[0]
            obj = annos.find_object(t, value["match"][-1])
            n_patched += _patch_det_annos(det_annos, token2idx, t, frame_box, static_f)
            if obj is None:
                continue
            preds.append(static_f)
            gts.append(box7_from_box9(np.asarray(obj["box"], np.float64)))
            inits.append(static_f[6])
            types.append(value["type"][j])
    return _relative_iou_metrics(preds, gts, inits, types, logger, "Static", dev)
