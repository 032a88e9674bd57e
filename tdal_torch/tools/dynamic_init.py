"""No-learning dynamic baseline: port of ``tools/dynamic_init.py``.

The lower bound the learned dynamic labeler must beat: each dynamic track's raw
per-frame detection boxes against the GT (the labelers' corner IoU, on ``--device``),
logged to ``<work_dir>/log/init.txt`` (default ``<work_dir>``: ``dynamic`` beside the
track file). No best-box broadcast: one box across a moving track means nothing.
"""

import argparse
from pathlib import Path

from tdal_torch.data.waymo_schema import AnnoStore, load_pickle, reorganize_info
from tdal_torch.pipeline.factories import load_track_data
from tdal_torch.pipeline.labeler_run import calculate_init_iou
from tdal_torch.runtime.logging_utils import DEFAULT_SEED, create_logger, fix_seed
from tdal_torch.tools._common import add_device


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--track", required=True, help="Path to trackDynamic.pkl.")
    parser.add_argument("--infos", required=True)
    parser.add_argument("--seed", type=int, default=DEFAULT_SEED)
    parser.add_argument("--work_dir", default=None)
    add_device(parser)
    args = parser.parse_args()

    fix_seed(args.seed)
    work_dir = Path(args.work_dir) if args.work_dir else Path(args.track).parent / "dynamic"
    work_dir.mkdir(parents=True, exist_ok=True)
    logger = create_logger(work_dir / "log" / "init.txt")

    track = load_track_data(args.track, prefix="trackDynamic")
    annos = AnnoStore(reorganize_info(load_pickle(args.infos)))
    calculate_init_iou(track, annos, logger, device=args.device)


if __name__ == "__main__":
    main()
