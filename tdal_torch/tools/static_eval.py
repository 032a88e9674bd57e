"""Static-object auto-labeler evaluation and label emission: port of
``tools/static_eval.py``.

The trained labeler over every matched track -> one refined box a track, broadcast to
its frames -> corner-IoU metrics (acc@0.7 vehicle / @0.5 cyclist) and the patched
det_annos in ``<work_dir>/box/<model_type>.pkl``.
"""

import argparse
from pathlib import Path

from tdal_torch.runtime.logging_utils import DEFAULT_SEED, create_logger, fix_seed
from tdal_torch.tools._common import add_device
from tdal_torch.tools._labeler import evaluate


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--track", required=True, help="Path to trackStatic.pkl.")
    parser.add_argument("--infos", required=True)
    parser.add_argument("--model_path", required=True, help="Checkpoint dir of static_train.")
    parser.add_argument("--model_type", required=True, choices=["one_box_est", "two_box_est"])
    parser.add_argument("--det_annos", default=None, help="Path to det_annos.pkl to patch.")
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--npoints", type=int, default=4096)
    parser.add_argument("--n_object_points", type=int, default=512)
    parser.add_argument("--seed", type=int, default=DEFAULT_SEED)
    parser.add_argument("--work_dir", default=None)
    add_device(parser)
    args = parser.parse_args()

    fix_seed(args.seed)
    work_dir = Path(args.work_dir) if args.work_dir else Path(args.track).parent / "static"
    logger = create_logger(work_dir / "log" / "eval" / f"{args.model_type}.txt")
    evaluate(args, "static", args.model_type, work_dir / "box" / f"{args.model_type}.pkl",
             logger)


if __name__ == "__main__":
    main()
