"""Dynamic-object auto-labeler evaluation and label emission: port of
``tools/dynamic_eval.py``.

The trained labeler over every per-frame sample, in order -> one refined box a frame
in that frame's vehicle coordinates -> corner-IoU metrics and the patched det_annos in
``<work_dir>/box/box.pkl``.
"""

import argparse
from pathlib import Path

from tdal_torch.runtime.logging_utils import DEFAULT_SEED, create_logger, fix_seed
from tdal_torch.tools._common import add_device
from tdal_torch.tools._labeler import evaluate


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--track", required=True, help="Path to trackDynamic.pkl.")
    parser.add_argument("--infos", required=True)
    parser.add_argument("--model_path", required=True, help="Checkpoint dir of dynamic_train.")
    parser.add_argument("--det_annos", default=None)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--npoints", type=int, default=1024)
    parser.add_argument("--n_object_points", type=int, default=2560)
    parser.add_argument("--seed", type=int, default=DEFAULT_SEED)
    parser.add_argument("--work_dir", default=None)
    add_device(parser)
    args = parser.parse_args()

    fix_seed(args.seed)
    work_dir = Path(args.work_dir) if args.work_dir else Path(args.track).parent / "dynamic"
    logger = create_logger(work_dir / "log" / "eval.txt")
    evaluate(args, "dynamic", "dynamic", work_dir / "box" / "box.pkl", logger)


if __name__ == "__main__":
    main()
