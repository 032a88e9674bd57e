"""Track data reorganisation (pipeline stage 3): port of ``tools/trackData.py``.

frame-keyed trackData pickles -> trackID-keyed {type, bbox, score, point, match,
token} dicts: ``track_{i}.pkl`` shards for a ``train`` work dir, ``track.pkl`` for
``val``.
"""

import argparse
import os

from tdal_torch.data.waymo_schema import dump_pickle, load_pickle
from tdal_torch.pipeline.track_extraction import reorganize
from tdal_torch.tools._common import shards


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--work_dir", required=True, help="Path to working dir (train or val).")
    parser.add_argument("--split", type=int, default=16, help="Number of train shards.")
    args = parser.parse_args()

    split_name = args.work_dir.rstrip("/").split("/")[-1]
    if split_name == "train":
        track = {}
        for i in range(args.split):
            track.update(load_pickle(os.path.join(args.work_dir, f"trackData_{i}.pkl")))
    elif split_name == "val":
        track = load_pickle(os.path.join(args.work_dir, "trackData.pkl"))
    else:
        raise NotImplementedError(f"split {split_name!r} not supported (train/val).")

    tracking = reorganize(track)
    if split_name == "train":
        for i, shard in enumerate(shards(tracking, args.split)):
            dump_pickle(shard, os.path.join(args.work_dir, f"track_{i}.pkl"))
    else:
        dump_pickle(tracking, os.path.join(args.work_dir, "track.pkl"))
    print(f"Reorganized {len(tracking)} tracks")


if __name__ == "__main__":
    main()
