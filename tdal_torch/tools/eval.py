"""Pipeline sanity eval: port of ``tools/eval.py``.

For each static label (``{ID: {'token', 'bbox'}}``): the 3D IoU with the frame's GT
boxes of the track's best-score box and of the static label, in f32 on ``--device``
(``tdal_torch.core.iou.boxes_iou_3d``); prints the mean of each one's best IoU.
"""

import argparse

import numpy as np
import torch

from tdal_torch.core.iou import boxes_iou_3d
from tdal_torch.data.waymo_schema import (
    AnnoStore, box7_from_box9, load_pickle, reorganize_info, transform_box_np,
)
from tdal_torch.device import resolve_device
from tdal_torch.tools._common import add_device


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--track", required=True, help="Path to track.pkl / trackStatic.pkl.")
    parser.add_argument("--infos", required=True)
    parser.add_argument("--static", required=True, help="Path to static_labels.pkl: {ID: {'token', 'bbox'}}.")
    add_device(parser)
    args = parser.parse_args()
    device = resolve_device(args.device)

    def best_iou(boxes, gt) -> float:
        iou = boxes_iou_3d(torch.as_tensor(boxes, dtype=torch.float32, device=device),
                           torch.as_tensor(gt, dtype=torch.float32, device=device))
        return float(iou[0].max())

    track = load_pickle(args.track)
    annos = AnnoStore(reorganize_info(load_pickle(args.infos)))
    static = load_pickle(args.static)

    iou_track, iou_static = [], []
    for ID, obj in static.items():
        token = obj["token"]
        static_bbox = np.asarray(obj["bbox"], np.float64).reshape(-1, 7)
        best = int(np.argmax(np.stack(track[ID]["score"])))
        track_bbox = transform_box_np(
            np.asarray(track[ID]["bbox"][best], np.float64).reshape(1, 7), annos.inv_pose(token))
        gt = np.stack([box7_from_box9(np.asarray(o["box"]))
                       for o in annos.get(token)["annos"]["objects"]])
        iou_track.append(best_iou(track_bbox, gt))
        s_iou = best_iou(static_bbox, gt)
        if s_iou <= 1:
            iou_static.append(s_iou)

    print(f"[Info] mIOU of track: {np.mean(iou_track):.4f}")
    print(f"[Info] mIOU of static: {np.mean(iou_static):.4f}")


if __name__ == "__main__":
    main()
