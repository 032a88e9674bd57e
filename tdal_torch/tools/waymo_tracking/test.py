"""3D multi-object tracking + track-data extraction (pipeline stage 2): port of
``tools/waymo_tracking/test.py``.

The detector's prediction.pkl -> global-frame boxes -> the greedy tracker per
sequence -> det_annos.pkl, the trackData pickles and the proto rows
(``tracking_pred.bin.pkl``) in ``--work_dir``, with the crop and GT match on
``--device``; and the GT's proto rows (``gt_preds.bin.pkl``).
"""

import argparse
from pathlib import Path

from tdal_torch.data.waymo_schema import AnnoStore, load_pickle, reorganize_info
from tdal_torch.pipeline.track_extraction import (
    convert_detection_to_global_box, create_gt_detection, create_pd_detection, run_tracking,
)
from tdal_torch.runtime.logging_utils import create_logger
from tdal_torch.tools._common import add_device


def parse_args():
    parser = argparse.ArgumentParser(description="Tracking Evaluation")
    parser.add_argument("--work_dir", required=True, help="dir to save logs and tracking results")
    parser.add_argument("--checkpoint", required=True, help="path to prediction file")
    parser.add_argument("--info_path", type=str, required=True)
    parser.add_argument("--max_age", type=int, default=3)
    parser.add_argument("--vehicle", type=float, default=0.8)
    parser.add_argument("--pedestrian", type=float, default=0.4)
    parser.add_argument("--cyclist", type=float, default=0.6)
    parser.add_argument("--score_thresh", type=float, default=0.75)
    add_device(parser)
    return parser.parse_args()


def main():
    args = parse_args()
    logger = create_logger(Path(args.work_dir) / "tracking.log")
    max_dist = {"VEHICLE": args.vehicle, "PEDESTRIAN": args.pedestrian,
                "CYCLIST": args.cyclist}
    detections = load_pickle(args.checkpoint)
    infos = reorganize_info(load_pickle(args.info_path))
    annos = AnnoStore(infos)

    global_preds, detection_results = convert_detection_to_global_box(detections, infos, annos)
    logger.info(f"Begin Tracking {len(global_preds)} frames")
    predictions, id_count = run_tracking(global_preds, detection_results,
                                         max_age=args.max_age, max_dist=max_dist,
                                         score_thresh=args.score_thresh)
    logger.info(f"Total track object: {id_count}")
    create_pd_detection(predictions, infos, args.work_dir, tracking=True, logger=logger,
                        device=args.device)
    create_gt_detection(list(infos.values()), args.work_dir, logger=logger)


if __name__ == "__main__":
    main()
