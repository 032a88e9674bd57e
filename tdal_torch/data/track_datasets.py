"""Track-keyed datasets for the static & dynamic auto-labelers.

A copy of ``tdal/data/track_datasets.py`` (datasets, ``collate``, ``batch_iterator``,
``parallel_batch_iterator``, ``Prefetcher``): the same numpy ``default_rng(seed)``
draws, so both packages yield identical batches.

Host-side numpy counterparts of reference ``STATICTRACK`` (tools/static_model.py:519-598)
and ``DYNAMICTRACK`` (tools/dynamic_model.py:400-535), producing fixed-shape batches for
the jit'd TPU step. Differences from the reference are throughput-only:

- annos are loaded once per token through :class:`AnnoStore` (the reference re-reads the
  pickle and re-inverts the pose for EVERY item: static_model.py:536-538,
  dynamic_model.py:449-483 — SURVEY.md §7 hard part 6),
- batches are stacked dense arrays (B, ...) with everything static-shaped,
- a seeded numpy Generator replaces global np.random state.

Label/canonicalization semantics are unchanged.
"""

from __future__ import annotations

import random
from typing import Dict, Iterator, Optional

import numpy as np

from tdal_torch.core.codecs import MEAN_SIZE_ARR
from tdal_torch.data.waymo_schema import (
    AnnoStore,
    box7_from_box9,
    points_in_rbbox_np,
    rotz_np,
    transform_box_np,
)

NUM_HEADING_BIN = 12


def _angle2class_np(angle: float, num_class: int = NUM_HEADING_BIN):
    """Scalar angle -> (bin, residual). Parity: tools/utils.py:53-60."""
    angle = angle % (2 * np.pi)
    angle_per_class = 2 * np.pi / float(num_class)
    shifted = (angle + angle_per_class / 2) % (2 * np.pi)
    class_id = int(shifted / angle_per_class)
    class_id = min(class_id, num_class - 1)
    residual = shifted - (class_id * angle_per_class + angle_per_class / 2)
    return class_id, residual


def _size2class_np(lwh: np.ndarray):
    """Parity: tools/utils.py:62-67."""
    diff = np.linalg.norm(lwh[None, :] - MEAN_SIZE_ARR, axis=1)
    class_id = int(np.argmin(diff))
    return class_id, lwh - MEAN_SIZE_ARR[class_id]


def preprocess_tracks(track: dict, annos: AnnoStore, ratio: float = 0.1, seed: Optional[int] = None):
    """Drop tracks whose best frame has no matching GT object; 90/10 train/val split.

    Parity: tools/static_train.py:29-51 preprocessing (python random.shuffle)."""
    kept = {}
    for k, v in track.items():
        score = np.stack(v["score"])
        token = v["token"][int(np.argmax(score))]
        if annos.find_object(token, v["match"][-1]) is not None:
            kept[k] = v
    items = list(kept.items())
    rng = random.Random(seed) if seed is not None else random
    rng.shuffle(items)
    n_val = int(ratio * len(items))
    return dict(items[n_val:]), dict(items[:n_val])


class StaticTrackDataset:
    """Per-track samples: merged multi-frame points in the best-score frame's vehicle
    coords, canonicalized into the init-box frame. Parity: STATICTRACK
    (static_model.py:519-598)."""

    def __init__(self, track: dict, annos: AnnoStore, npoints: int = 4096, seed: int = 0):
        self.track_ids = list(track.keys())
        self.tracks = list(track.values())
        self.annos = annos
        self.npoints = npoints
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.tracks)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        tr = self.tracks[index]
        score = np.stack(tr["score"])
        best = int(np.argmax(score))
        token = tr["token"][best]

        inv_pose = self.annos.inv_pose(token)
        init_box = transform_box_np(
            np.asarray(tr["bbox"][best], np.float64)[None], inv_pose
        )[0]

        point = np.concatenate([np.asarray(p).reshape(-1, 3) for p in tr["point"]], axis=0)
        point = point @ inv_pose[:3, :3].T + inv_pose[:3, 3]

        choice = self.rng.choice(point.shape[0], self.npoints, replace=True)
        point = point[choice]

        obj = self.annos.find_object(token, tr["match"][-1])
        bbox_gt = box7_from_box9(np.asarray(obj["box"], np.float64))

        mask_label = points_in_rbbox_np(point, bbox_gt[None]).astype(np.float32)[:, 0]
        center_label = bbox_gt[:3]
        h_cls, h_res = _angle2class_np(bbox_gt[6] - init_box[6])
        s_cls, s_res = _size2class_np(bbox_gt[3:6])

        # Canonicalize into the init-box frame (static_model.py:569-570).
        point = (point - init_box[:3]) @ rotz_np(-init_box[6]).T

        return {
            "track_id": self.track_ids[index],
            "token": token,
            "pts": point.astype(np.float32),
            "init_box": init_box.astype(np.float32),
            "bbox_gt": bbox_gt.astype(np.float32),
            "mask_label": mask_label,
            "center_label": center_label.astype(np.float32),
            "heading_class_label": np.int32(h_cls),
            "heading_residuals_label": np.float32(h_res),
            "size_class_label": np.int32(s_cls),
            "size_residuals_label": s_res.astype(np.float32),
        }


class DynamicTrackDataset:
    """Per-frame samples over dynamic tracks: +-r frame point window with frame-time
    channel, +-s frame box trajectory, labels relative to the center-frame box.
    Parity: DYNAMICTRACK (dynamic_model.py:400-535)."""

    def __init__(self, track: dict, annos: AnnoStore, npoints: int = 1024, r: int = 2, s: int = 50, seed: int = 0):
        self.track_ids = list(track.keys())
        self.tracks = list(track.values())
        self.annos = annos
        self.npoints = npoints
        self.r = r
        self.s = s
        self.rng = np.random.default_rng(seed)
        # Cumulative per-track frame offsets (dynamic_model.py:407-424 'heads').
        self.heads = np.cumsum([0] + [len(t["point"]) for t in self.tracks])
        self._pt_cache: Dict[int, dict] = {}
        self._bbox_cache: Dict[int, np.ndarray] = {}

    def _pts(self, track_idx: int, frame_idx: int) -> np.ndarray:
        cache = self._pt_cache.setdefault(track_idx, {})
        if frame_idx not in cache:
            cache[frame_idx] = np.asarray(
                self.tracks[track_idx]["point"][frame_idx]
            ).reshape(-1, 3)
        return cache[frame_idx]

    def _bbox_arr(self, track_idx: int) -> np.ndarray:
        if track_idx not in self._bbox_cache:
            self._bbox_cache[track_idx] = np.stack(
                [np.asarray(b).reshape(7) for b in self.tracks[track_idx]["bbox"]]
            )
        return self._bbox_cache[track_idx]

    def __len__(self):
        return int(self.heads[-1])

    def _locate(self, index: int):
        track_idx = int(np.searchsorted(self.heads, index, side="right") - 1)
        return track_idx, index - int(self.heads[track_idx])

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        for _ in range(len(self) + 1):
            item = self._try_getitem(index)
            if item is not None:
                return item
            # Missing GT at the center frame: resample another item
            # (dynamic_model.py:486-488).
            index = int(self.rng.integers(len(self)))
        raise RuntimeError("no dynamic track item has GT at its center frame")

    def _try_getitem(self, index: int):
        track_idx, item_idx = self._locate(index)
        tr = self.tracks[track_idx]
        n_frames = len(tr["point"])
        token = tr["token"][item_idx]
        r, s, npts = self.r, self.s, self.npoints

        # ---- point window (5 * npoints, 4), zero-filled out of range ----
        chunks = []
        for j, i in enumerate(range(item_idx - r, item_idx + r + 1)):
            t_ch = np.full((npts, 1), 0.1 * (j - r))
            if 0 <= i < n_frames and len(tr["point"][i]) > 0:
                pts_i = np.asarray(tr["point"][i]).reshape(-1, 3)
                choice = self.rng.choice(pts_i.shape[0], npts, replace=True)
                chunks.append(np.hstack([pts_i[choice], t_ch]))
            else:
                chunks.append(np.hstack([np.zeros((npts, 3)), t_ch]))
        point = np.concatenate(chunks, axis=0)  # (5*npts, 4), global frame

        # ---- box trajectory (2s+1, 8), zero-filled out of range ----
        boxes = np.zeros((2 * s + 1, 8))
        boxes[:, 7] = 0.1 * (np.arange(2 * s + 1) - s)
        for j, i in enumerate(range(item_idx - s, item_idx + s + 1)):
            if 0 <= i < n_frames:
                boxes[j, :7] = np.asarray(tr["bbox"][i]).reshape(7)

        # ---- global -> center-frame vehicle coords ----
        inv_pose = self.annos.inv_pose(token)
        in_range = (np.arange(2 * s + 1) - s + item_idx >= 0) & (
            np.arange(2 * s + 1) - s + item_idx < n_frames
        )
        boxes[in_range, :7] = transform_box_np(boxes[in_range, :7], inv_pose)
        point[:, :3] = point[:, :3] @ inv_pose[:3, :3].T + inv_pose[:3, 3]

        # ---- per-frame mask labels (need each frame's own pose + GT box) ----
        mask_label = np.zeros((2 * r + 1, npts), np.float32)
        bbox_gt = None
        pose_center = self.annos.pose(token)  # vehicle(center) -> global
        for j, i in enumerate(range(item_idx - r, item_idx + r + 1)):
            if not (0 <= i < n_frames):
                continue
            t = tr["token"][i]
            obj = self.annos.find_object(t, tr["match"][-1])
            if obj is None:
                continue
            bbox_t = box7_from_box9(np.asarray(obj["box"], np.float64))
            if i == item_idx:
                bbox_gt = bbox_t.copy()
            # center-frame vehicle -> global -> frame-i vehicle (dynamic_model.py:481-483)
            m = self.annos.inv_pose(t) @ pose_center
            p = point[j * npts : (j + 1) * npts, :3] @ m[:3, :3].T + m[:3, 3]
            mask_label[j] = points_in_rbbox_np(p, bbox_t[None]).astype(np.float32)[:, 0]
        mask_label = mask_label.reshape(-1)

        if bbox_gt is None:
            return None

        init_box = boxes[s].copy()  # (8,): center-frame box + time 0
        center_label = bbox_gt[:3] - boxes[s, :3]
        h_cls, h_res = _angle2class_np(bbox_gt[6] - boxes[s, 6])
        s_cls, s_res = _size2class_np(bbox_gt[3:6])

        # Canonicalize into the center-frame box frame (dynamic_model.py:502-507).
        rot = rotz_np(-boxes[s, 6]).T
        point[:, :3] = (point[:, :3] - boxes[s, :3]) @ rot
        boxes[:, :3] = boxes[:, :3] - boxes[s, :3]
        boxes[:, 6] = boxes[:, 6] - boxes[s, 6]

        return {
            "track_id": self.track_ids[track_idx],
            "token": token,
            "pts": point.astype(np.float32),
            "boxes": boxes.astype(np.float32),
            "init_box": init_box.astype(np.float32),
            "bbox_gt": bbox_gt.astype(np.float32),
            "mask_label": mask_label,
            "center_label": center_label.astype(np.float32),
            "heading_class_label": np.int32(h_cls),
            "heading_residuals_label": np.float32(h_res),
            "size_class_label": np.int32(s_cls),
            "size_residuals_label": s_res.astype(np.float32),
        }

    def build_batch(self, indices) -> Dict[str, np.ndarray]:
        """Vectorized batch assembly (VERDICT r2 item 7): the window point
        gather, pose re-projections, in-box mask tests, and canonicalization
        run as batched numpy over ALL items at once — the per-item path costs
        ~2 ms/item of python overhead on a 1-core host, which made the loader
        slower than the ~30 ms train step at B=64. Semantics match
        ``__getitem__`` exactly except the random point-choice stream (a
        different but equally-uniform with-replacement draw)."""
        r, s, npts = self.r, self.s, self.npoints
        W, S = 2 * r + 1, 2 * s + 1

        # ---- resolve to valid (track, frame) pairs (resample-on-missing-GT,
        # dynamic_model.py:486-488) ----
        locs = []
        for index in indices:
            index = int(index)
            for _ in range(len(self) + 1):
                ti, ii = self._locate(index)
                tr = self.tracks[ti]
                if self.annos.find_object(tr["token"][ii], tr["match"][-1]) is not None:
                    break
                index = int(self.rng.integers(len(self)))
            else:
                raise RuntimeError("no dynamic track item has GT at its center frame")
            locs.append((ti, ii))
        B = len(locs)

        # ---- per-item structure walk (light python; heavy math is batched) ----
        srcs: list = []  # B*W point arrays (or None out of range/empty)
        Ms = np.zeros((B, W, 4, 4))  # frame-j vehicle <- center vehicle
        gt_bx = np.zeros((B, W, 7))
        gt_valid = np.zeros((B, W), bool)
        inv_poses = np.zeros((B, 4, 4))
        boxes = np.zeros((B, S, 8))
        boxes[:, :, 7] = 0.1 * (np.arange(S) - s)
        in_range = np.zeros((B, S), bool)
        bbox_gt = np.zeros((B, 7))
        track_ids, tokens = [], []
        for b, (ti, ii) in enumerate(locs):
            tr = self.tracks[ti]
            nf = len(tr["point"])
            token = tr["token"][ii]
            track_ids.append(self.track_ids[ti])
            tokens.append(token)
            inv_poses[b] = self.annos.inv_pose(token)
            pose_center = self.annos.pose(token)
            match = tr["match"][-1]
            for j, i in enumerate(range(ii - r, ii + r + 1)):
                if 0 <= i < nf:
                    p = self._pts(ti, i)
                    srcs.append(p if len(p) else None)
                    t = tr["token"][i]
                    obj = self.annos.find_object(t, match)
                    if obj is not None:
                        gt_bx[b, j] = box7_from_box9(np.asarray(obj["box"], np.float64))
                        gt_valid[b, j] = True
                        if i == ii:
                            bbox_gt[b] = gt_bx[b, j]
                    Ms[b, j] = self.annos.inv_pose(t) @ pose_center
                else:
                    srcs.append(None)
            arr = self._bbox_arr(ti)
            lo, hi = ii - s, ii + s + 1
            src_lo, src_hi = max(lo, 0), min(hi, nf)
            boxes[b, src_lo - lo : src_hi - lo, :7] = arr[src_lo:src_hi]
            in_range[b, src_lo - lo : src_hi - lo] = True

        # ---- one random gather over all B*W window slots ----
        lens = np.array([0 if a is None else len(a) for a in srcs], np.int64)
        nonempty = lens > 0
        cat = (
            np.concatenate([a for a in srcs if a is not None and len(a)])
            if nonempty.any()
            else np.zeros((1, 3))
        )
        offs = np.concatenate([[0], np.cumsum(lens)])[:-1]
        pick = (self.rng.random((B * W, npts)) * np.maximum(lens, 1)[:, None]).astype(np.int64)
        flat = np.minimum(offs[:, None] + pick, len(cat) - 1)
        pts = cat[flat]  # (B*W, npts, 3) in the global frame
        pts[~nonempty] = 0.0  # empty slots are zero-filled in GLOBAL coords
        pts = pts.reshape(B, W, npts, 3)

        # ---- global -> center-frame vehicle coords (batched) ----
        R, t = inv_poses[:, :3, :3], inv_poses[:, :3, 3]
        pts_c = pts @ R.transpose(0, 2, 1)[:, None] + t[:, None, None, :]

        # ---- per-frame mask labels: re-project into each frame's vehicle
        # coords and test against that frame's GT box (dynamic_model.py:481-483) ----
        MR, Mt = Ms[:, :, :3, :3], Ms[:, :, :3, 3]
        p_f = pts_c @ MR.transpose(0, 1, 3, 2) + Mt[:, :, None, :]
        d = p_f - gt_bx[:, :, None, :3]
        ch, sh = np.cos(gt_bx[..., 6]), np.sin(gt_bx[..., 6])
        lx = ch[..., None] * d[..., 0] + sh[..., None] * d[..., 1]
        ly = -sh[..., None] * d[..., 0] + ch[..., None] * d[..., 1]
        half = gt_bx[..., 3:6] * 0.5
        inb = (
            (np.abs(lx) <= half[..., None, 0])
            & (np.abs(ly) <= half[..., None, 1])
            & (np.abs(d[..., 2]) <= half[..., None, 2])
        )
        mask_label = (inb & gt_valid[..., None]).astype(np.float32).reshape(B, W * npts)

        # ---- box trajectory: global -> center vehicle (batched transform_box) ----
        ctr = boxes[..., :3] @ R.transpose(0, 2, 1) + t[:, None, :]
        hdg = boxes[..., 6] + np.arctan2(R[:, 1, 0], R[:, 0, 0])[:, None]
        boxes[..., :3] = np.where(in_range[..., None], ctr, boxes[..., :3])
        boxes[..., 6] = np.where(in_range, hdg, boxes[..., 6])

        # ---- labels (scalar codecs per item: trivial cost) ----
        center_label = bbox_gt[:, :3] - boxes[:, s, :3]
        h_cls = np.zeros(B, np.int32)
        h_res = np.zeros(B, np.float32)
        s_cls = np.zeros(B, np.int32)
        s_res = np.zeros((B, 3), np.float32)
        for b in range(B):
            h_cls[b], h_res[b] = _angle2class_np(bbox_gt[b, 6] - boxes[b, s, 6])
            s_cls[b], s_res[b] = _size2class_np(bbox_gt[b, 3:6])

        # ---- canonicalize into the center-frame box frame (batched) ----
        init_box = boxes[:, s].copy()
        hc = boxes[:, s, 6]
        rot = np.zeros((B, 3, 3))
        rot[:, 0, 0] = np.cos(-hc)
        rot[:, 0, 1] = -np.sin(-hc)
        rot[:, 1, 0] = np.sin(-hc)
        rot[:, 1, 1] = np.cos(-hc)
        rot[:, 2, 2] = 1.0
        centered = pts_c.reshape(B, W * npts, 3) - boxes[:, s, None, :3]
        # per-item code: point @ rotz(-h).T
        pts_out = centered @ rot.transpose(0, 2, 1)
        boxes[..., :3] = boxes[..., :3] - boxes[:, s, None, :3]
        boxes[..., 6] = boxes[..., 6] - boxes[:, s, 6, None]

        return {
            "track_id": track_ids,
            "token": tokens,
            "pts": np.concatenate(
                [
                    pts_out.reshape(B, W, npts, 3),
                    np.broadcast_to(
                        (0.1 * (np.arange(W) - r))[None, :, None, None],
                        (B, W, npts, 1),
                    ),
                ],
                axis=-1,
            ).reshape(B, W * npts, 4).astype(np.float32),
            "boxes": boxes.astype(np.float32),
            "init_box": init_box.astype(np.float32),
            "bbox_gt": bbox_gt.astype(np.float32),
            "mask_label": mask_label,
            "center_label": center_label.astype(np.float32),
            "heading_class_label": h_cls,
            "heading_residuals_label": h_res,
            "size_class_label": s_cls,
            "size_residuals_label": s_res,
        }


_META_KEYS = ("track_id", "token")


def collate(items) -> Dict[str, np.ndarray]:
    """Stack a list of item dicts into dense (B, ...) arrays; meta keys become lists."""
    out = {}
    for k in items[0]:
        if k in _META_KEYS:
            out[k] = [it[k] for it in items]
        else:
            out[k] = np.stack([it[k] for it in items])
    return out


def batch_iterator(
    dataset,
    batch_size: int,
    shuffle: bool = False,
    seed: int = 0,
    drop_last: bool = False,
    pad_to_full: bool = False,
) -> Iterator[Dict[str, np.ndarray]]:
    """Epoch iterator over fixed-size batches.

    pad_to_full repeats the last item so every batch has exactly batch_size rows
    (static shapes => one XLA compilation); 'n_valid' records the real count."""
    n = len(dataset)
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    for start in range(0, n, batch_size):
        sel = idx[start : start + batch_size]
        if len(sel) < batch_size:
            if drop_last:
                return
            if pad_to_full:
                sel = np.concatenate([sel, np.full(batch_size - len(sel), sel[-1])])
        if hasattr(dataset, "build_batch"):
            batch = dataset.build_batch(sel)
        else:
            batch = collate([dataset[int(i)] for i in sel])
        batch["n_valid"] = min(batch_size, n - start)
        yield batch


_POOL_DATASET = None  # each worker's copy of the dataset (set by _init_pool)


def _init_pool(dataset):
    global _POOL_DATASET
    _POOL_DATASET = dataset


def _pool_make_batch(args):
    sel, n_valid = args
    batch = collate([_POOL_DATASET[int(i)] for i in sel])
    batch["n_valid"] = n_valid
    return batch


def parallel_batch_iterator(dataset, batch_size: int, num_workers: int = 4,
                            shuffle: bool = False, seed: int = 0, drop_last: bool = False,
                            pad_to_full: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """``batch_iterator``'s batches, in its order, each collated from the dataset's
    items by a pool of ``num_workers`` spawned processes (safe beside CUDA and threads;
    each worker unpickles one copy of the dataset, so a dataset that draws from its own
    generator draws from that worker's copy). With ``num_workers`` 0 it is
    ``batch_iterator``."""
    if num_workers <= 0:
        yield from batch_iterator(dataset, batch_size, shuffle=shuffle, seed=seed,
                                  drop_last=drop_last, pad_to_full=pad_to_full)
        return
    import multiprocessing as mp

    n = len(dataset)
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    jobs = []
    for start in range(0, n, batch_size):
        sel = idx[start : start + batch_size]
        if len(sel) < batch_size:
            if drop_last:
                break
            if pad_to_full:
                sel = np.concatenate([sel, np.full(batch_size - len(sel), sel[-1])])
        jobs.append((sel, min(batch_size, n - start)))
    with mp.get_context("spawn").Pool(num_workers, initializer=_init_pool,
                                      initargs=(dataset,)) as pool:
        yield from pool.imap(_pool_make_batch, jobs, chunksize=1)


class Prefetcher:
    """Runs ``iterator`` on a thread, ``depth`` items ahead of the consumer; an error
    raised there is raised again in the consumer. Parity: det3d/solver/background.py."""

    def __init__(self, iterator, depth: int = 2):
        import queue
        import threading

        self._q = queue.Queue(maxsize=depth)
        self._end = object()

        def worker():
            try:
                for item in iterator:
                    self._q.put((True, item))
            except Exception as e:  # handed over to the consumer
                self._q.put((False, e))
            self._q.put((True, self._end))

        threading.Thread(target=worker, daemon=True).start()

    def __iter__(self):
        while True:
            ok, item = self._q.get()
            if not ok:
                raise item
            if item is self._end:
                return
            yield item
