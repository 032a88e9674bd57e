"""GT track builder (pipeline stage 4a): port of ``tools/trackGT.py``.

Groups GT boxes by object name across frames in the global frame; a track is static
iff its displacement < 1 m and its largest speed < 1 m/s.
"""

import argparse

from tdal_torch.data.waymo_schema import dump_pickle, load_pickle
from tdal_torch.pipeline.motion_state import build_track_gt


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--infos", required=True, help="Path to infos file.")
    parser.add_argument("--result", required=True, help="Path to result file.")
    args = parser.parse_args()

    trackGT = build_track_gt(load_pickle(args.infos))
    dump_pickle(trackGT, args.result)
    n_static = sum(v["static"] for v in trackGT.values())
    print(f"{len(trackGT)} GT tracks ({n_static} static)")


if __name__ == "__main__":
    main()
