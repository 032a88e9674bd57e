"""Tracker hyperparameter grid search: port of ``tools/waymo_tracking/line_search.py``.

The detector's prediction.pkl -> global-frame boxes once, then the greedy tracker at
every (score threshold, vehicle distance) of the grid (pedestrian and cyclist
distances at 1/2 and 3/4 of the vehicle's), printing the tracks and boxes each keeps.
Host work only, so no ``--device``.
"""

import argparse
import itertools

from tdal_torch.data.waymo_schema import AnnoStore, load_pickle, reorganize_info
from tdal_torch.pipeline.track_extraction import convert_detection_to_global_box, run_tracking


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", required=True, help="prediction.pkl")
    parser.add_argument("--info_path", required=True)
    parser.add_argument("--score_thresholds", type=float, nargs="+",
                        default=[0.5, 0.65, 0.75, 0.85])
    parser.add_argument("--vehicle_dists", type=float, nargs="+", default=[0.6, 0.8, 1.0])
    parser.add_argument("--max_age", type=int, default=3)
    args = parser.parse_args()

    detections = load_pickle(args.checkpoint)
    infos = reorganize_info(load_pickle(args.info_path))
    annos = AnnoStore(infos)
    global_preds, det_results = convert_detection_to_global_box(detections, infos, annos)

    for score, vdist in itertools.product(args.score_thresholds, args.vehicle_dists):
        max_dist = {"VEHICLE": vdist, "PEDESTRIAN": vdist / 2, "CYCLIST": vdist * 0.75}
        preds, id_count = run_tracking(
            global_preds, det_results, max_age=args.max_age,
            max_dist=max_dist, score_thresh=score,
        )
        n_boxes = sum(len(p["scores"]) for p in preds.values())
        print(f"score_thresh={score:.2f} vehicle_dist={vdist:.2f} "
              f"-> {id_count} tracks, {n_boxes} boxes")


if __name__ == "__main__":
    main()
