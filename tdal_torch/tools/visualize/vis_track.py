"""Tracks, each as its merged points and box sequence: port of
``tools/visualize/vis_track.py``.

``python -m tdal_torch.tools.visualize.vis_track --track track.pkl`` writes
``<out_dir>/track_<id>.png`` for the first ``--n_tracks`` tracks, or with ``--open3d``
opens the 3D viewer on each.
"""

import argparse
from pathlib import Path

from tdal_torch.data.waymo_schema import load_pickle
from tdal_torch.utils.visualize import plot_track, show_track_open3d


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--track", required=True, help="track.pkl / trackStatic.pkl")
    parser.add_argument("--out_dir", default="vis_out")
    parser.add_argument("--n_tracks", type=int, default=5)
    parser.add_argument("--open3d", action="store_true",
                        help="interactive 3D viewer (needs open3d)")
    args = parser.parse_args(argv)

    for tid, tr in list(load_pickle(args.track).items())[: args.n_tracks]:
        if args.open3d:
            show_track_open3d(tr)
            continue
        out = Path(args.out_dir) / f"track_{tid}.png"
        plot_track(tr, None, out_path=out, title=str(tid))
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
