"""Raw frames with their GT boxes: port of ``tools/visualize/vis_data.py``.

``python -m tdal_torch.tools.visualize.vis_data --infos INFOS`` writes
``<out_dir>/<token>.png`` (BEV) for the first ``--n_frames`` frames, or with
``--open3d`` opens the 3D viewer on each.
"""

import argparse
from pathlib import Path

import numpy as np

from tdal_torch.data.waymo_schema import box7_from_box9, load_pickle
from tdal_torch.utils.visualize import plot_bev, show_open3d


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--infos", required=True)
    parser.add_argument("--out_dir", default="vis_out")
    parser.add_argument("--n_frames", type=int, default=5)
    parser.add_argument("--open3d", action="store_true")
    args = parser.parse_args(argv)

    for info in load_pickle(args.infos)[: args.n_frames]:
        lidar = load_pickle(info["path"])
        anno = load_pickle(info["anno_path"])
        points = lidar["lidars"]["points_xyz"]
        boxes = np.array([box7_from_box9(o["box"]) for o in anno["objects"]])
        if args.open3d:
            show_open3d(points, boxes)
        else:
            out = Path(args.out_dir) / f"{info['token']}.png"
            plot_bev(points=points, gt_boxes=boxes, out_path=out, title=info["token"])
            print(f"wrote {out}")


if __name__ == "__main__":
    main()
