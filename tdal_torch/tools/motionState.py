"""Motion-state classification (pipeline stage 4b): port of ``tools/motionState.py``.

Per-track features [displacement, center variance]; a linear SVM fit on the train
split's GT static bit; trackStatic / trackDynamic pickles (the GT split for train, the
predicted split for val).
"""

import argparse
import os

from tdal_torch.data.waymo_schema import dump_pickle, load_pickle
from tdal_torch.pipeline.motion_state import (
    fit_motion_classifier, split_by_prediction, track_features,
)
from tdal_torch.runtime.logging_utils import DEFAULT_SEED, fix_seed
from tdal_torch.tools._common import shards


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--track_train", required=True, help="Path to train track data dir.")
    parser.add_argument("--track_val", required=True, help="Path to val track data dir.")
    parser.add_argument("--split", type=int, default=16)
    args = parser.parse_args()

    fix_seed(DEFAULT_SEED)

    print("> Reading train data")
    track_train = {}
    for i in range(args.split):
        track_train.update(load_pickle(os.path.join(args.track_train, f"track_{i}.pkl")))
    trackGT_train = load_pickle(os.path.join(args.track_train, "trackGT.pkl"))

    print("> Processing train data")
    trainX, trainY, static, dynamic = track_features(track_train, trackGT_train, training=True)

    print("> Saving train trackStatic/trackDynamic shards")
    for name, data in (("trackStatic", static), ("trackDynamic", dynamic)):
        for i, shard in enumerate(shards(data, args.split)):
            dump_pickle(shard, os.path.join(args.track_train, f"{name}_{i}.pkl"))

    print("> Reading val data")
    track_val = load_pickle(os.path.join(args.track_val, "track.pkl"))
    trackGT_val = load_pickle(os.path.join(args.track_val, "trackGT.pkl"))
    valX, valY, new_track_val = track_features(track_val, trackGT_val)

    print(f"[Info] Number of train: {trainX.shape[0]}")
    print(f"[Info] Number of val: {valX.shape[0]}")

    clf = fit_motion_classifier(trainX, trainY)
    if len(valX):
        print(f"> Score on test set: {clf.score(valX, valY)}")
        y_pred = clf.predict(valX)
    else:
        y_pred = []
    trackStatic, trackDynamic = split_by_prediction(new_track_val, y_pred)
    dump_pickle(trackStatic, os.path.join(args.track_val, "trackStatic.pkl"))
    dump_pickle(trackDynamic, os.path.join(args.track_val, "trackDynamic.pkl"))
    print(f"> val: {len(trackStatic)} static, {len(trackDynamic)} dynamic tracks")


if __name__ == "__main__":
    main()
