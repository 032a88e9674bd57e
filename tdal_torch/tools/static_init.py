"""No-learning static baselines: port of ``tools/static_init.py``.

The two lower bounds the learned static labeler must beat: the raw detections' IoU
with the GT, and the IoU of each track's best-score box broadcast to all its frames,
logged to ``<work_dir>/log/init.txt`` (default ``<work_dir>``: ``static`` beside the
track file). With ``--det_annos`` the broadcast box patches the det_annos rows, saved
as ``<work_dir>/box/static_init.pkl``. The IoUs run on ``--device``.
"""

import argparse
from pathlib import Path

from tdal_torch.data.track_datasets import preprocess_tracks
from tdal_torch.data.waymo_schema import AnnoStore, dump_pickle, load_pickle, reorganize_info
from tdal_torch.pipeline.factories import load_track_data
from tdal_torch.pipeline.labeler_run import (
    build_token2idx, calculate_init_iou, calculate_static_iou, sort_detections,
)
from tdal_torch.runtime.logging_utils import DEFAULT_SEED, create_logger, fix_seed
from tdal_torch.tools._common import add_device


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--track", required=True, help="Path to trackStatic.pkl.")
    parser.add_argument("--infos", required=True)
    parser.add_argument("--det_annos", default=None)
    parser.add_argument("--seed", type=int, default=DEFAULT_SEED)
    parser.add_argument("--work_dir", default=None)
    add_device(parser)
    args = parser.parse_args()

    fix_seed(args.seed)
    work_dir = Path(args.work_dir) if args.work_dir else Path(args.track).parent / "static"
    (work_dir / "box").mkdir(parents=True, exist_ok=True)
    logger = create_logger(work_dir / "log" / "init.txt")

    track = load_track_data(args.track, prefix="trackStatic")
    info_map = reorganize_info(load_pickle(args.infos))
    annos = AnnoStore(info_map)
    track, _ = preprocess_tracks(track, annos, ratio=0.0, seed=args.seed)

    det_annos, token2idx = None, None
    if args.det_annos:
        det_annos = sort_detections(load_pickle(args.det_annos))
        token2idx = build_token2idx(info_map, annos, det_annos)

    calculate_init_iou(track, annos, logger, device=args.device)
    calculate_static_iou(track, annos, logger, det_annos, token2idx, device=args.device)
    if det_annos is not None:
        out_path = work_dir / "box" / "static_init.pkl"
        dump_pickle(det_annos, out_path)
        logger.info(f"Saved patched det_annos to {out_path}")


if __name__ == "__main__":
    main()
