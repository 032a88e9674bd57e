"""Dynamic-object auto-labeler training: port of ``tools/dynamic_train.py``.

trackDynamic shards + infos -> unmatched tracks dropped, a 90/10 split -> the
per-frame dynamic Frustum-PointNet (+ box-trajectory embedding) trained with AdamW on
the step-decay schedule, the best checkpoint under ``<work_dir>/model``.
"""

import argparse
from pathlib import Path

from tdal_torch.runtime.logging_utils import DEFAULT_SEED
from tdal_torch.tools._common import add_device
from tdal_torch.tools._labeler import add_train_args, train


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--track", required=True, help="Path to trackDynamic.pkl or shard dir.")
    parser.add_argument("--seed", type=int, default=DEFAULT_SEED)
    add_train_args(parser, npoints=1024, n_object_points=2560)
    add_device(parser)
    args = parser.parse_args()

    work_dir = Path(args.work_dir) if args.work_dir else Path(args.track) / "dynamic"
    train(args, "dynamic", "dynamic", work_dir / "model", work_dir / "log" / "train.txt")


if __name__ == "__main__":
    main()
