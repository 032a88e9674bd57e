"""Static-object auto-labeler training: port of ``tools/static_train.py``.

trackStatic shards + infos -> unmatched tracks dropped, a 90/10 split -> a one-box or
two-box Frustum-PointNet trained with AdamW on the step-decay schedule, evaluated each
epoch, the best checkpoint (eval acc@0.7) under ``<work_dir>/model/<model_type>``.
"""

import argparse
from pathlib import Path

from tdal_torch.runtime.logging_utils import DEFAULT_SEED
from tdal_torch.tools._common import add_device
from tdal_torch.tools._labeler import add_train_args, train


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--track", required=True, help="Path to trackStatic.pkl or shard dir.")
    parser.add_argument("--model_type", required=True, choices=["one_box_est", "two_box_est"])
    parser.add_argument("--seed", type=int, default=DEFAULT_SEED)
    add_train_args(parser, npoints=4096, n_object_points=512)
    add_device(parser)
    args = parser.parse_args()

    work_dir = Path(args.work_dir) if args.work_dir else Path(args.track) / "static"
    train(args, "static", args.model_type, work_dir / "model" / args.model_type,
          work_dir / "log" / "train" / f"{args.model_type}.txt")


if __name__ == "__main__":
    main()
