"""Predictions against GT, frame by frame: port of ``tools/visualize/vis_pred.py``.

``python -m tdal_torch.tools.visualize.vis_pred --prediction prediction.pkl --infos
INFOS`` writes ``<out_dir>/<token>.png`` for the first ``--n_frames`` predicted frames:
the boxes scoring above ``--score_thresh`` (turned into the Waymo convention) over the
GT. ``--open3d`` opens the 3D viewer on each frame, with ``--prediction2`` as a second
set in blue; ``--open3d --sequence`` opens one window that the N and P keys step.
"""

import argparse
from pathlib import Path

import numpy as np

from tdal_torch.data.waymo_schema import box7_from_box9, load_pickle, reorganize_info
from tdal_torch.utils.visualize import plot_bev, show_open3d, show_sequence_open3d


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--prediction", required=True, help="prediction.pkl")
    parser.add_argument("--infos", required=True)
    parser.add_argument("--out_dir", default="vis_out")
    parser.add_argument("--n_frames", type=int, default=5)
    parser.add_argument("--score_thresh", type=float, default=0.3)
    parser.add_argument("--open3d", action="store_true",
                        help="interactive 3D viewer (needs open3d)")
    parser.add_argument("--prediction2", default=None,
                        help="second prediction.pkl for A/B comparison "
                             "(reference vis_pred.py --pred1/--pred2)")
    parser.add_argument("--sequence", action="store_true",
                        help="with --open3d: one window, N/P keys step frames")
    args = parser.parse_args(argv)

    preds = load_pickle(args.prediction)
    preds2 = load_pickle(args.prediction2) if args.prediction2 else None
    infos = reorganize_info(load_pickle(args.infos))

    def det_sets(token):
        """The frame's prediction box sets above the threshold, Waymo convention."""
        sets = []
        for name, color, src in (("pred", (0.9, 0.1, 0.1), preds),
                                 ("pred2", (0.1, 0.3, 0.9), preds2)):
            if src is None or token not in src:
                continue
            det = src[token]
            keep = np.asarray(det["scores"]) > args.score_thresh
            boxes = np.asarray(det["box3d_lidar"])[keep][:, :7].copy()
            if len(boxes):
                boxes[:, -1] = -boxes[:, -1] - np.pi / 2
                boxes[:, [3, 4]] = boxes[:, [4, 3]]
            sets.append({"boxes": boxes, "color": color, "name": name,
                         "scores": np.asarray(det["scores"])[keep]})
        return sets

    def frame(token):
        info = infos[token]
        anno = load_pickle(info["anno_path"])
        gt = np.array([box7_from_box9(o["box"]) for o in anno["objects"]])
        return load_pickle(info["path"])["lidars"]["points_xyz"], gt

    tokens = list(preds)[: args.n_frames]
    if args.open3d and args.sequence:
        frames = []
        for token in tokens:
            points, gt = frame(token)
            frames.append({"points": points, "gt": gt, "sets": det_sets(token)})
        show_sequence_open3d(frames, score_thresh=args.score_thresh)
        return

    for token in tokens:
        det = preds[token]
        points, gt = frame(token)
        keep = np.asarray(det["scores"]) > args.score_thresh
        sets = det_sets(token)
        boxes = sets[0]["boxes"] if sets else np.zeros((0, 7))
        if args.open3d:
            show_open3d(points, boxes=gt, box_sets=sets, score_thresh=args.score_thresh)
            continue
        out = Path(args.out_dir) / f"{token}.png"
        plot_bev(points=points, boxes=boxes, labels=np.asarray(det["label_preds"])[keep],
                 gt_boxes=gt, out_path=out, title=token)
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
