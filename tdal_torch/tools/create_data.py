"""Data preparation: port of ``tools/create_data.py``, the same subcommands and
arguments.

- ``waymo_data_prep --root_path R [--split S] [--nsweeps N] [--no_gt_database]``: the
  infos pickle of ``R/S`` (``R/infos_S_NNsweeps_filter_zero_gt.pkl``) and, for the
  train split, the GT database (``R/gt_database_Nsweeps_withvelo/<class>/*.bin`` and
  ``R/dbinfos_train_Nsweeps_withvelo.pkl``) that the GT-aug sampler of ``train`` reads;
- ``frame_cache --info_path I [--no_sweeps]``: a ``.tdc`` point cache next to every
  frame pickle of ``I``;
- ``waymo_convert``: tfrecords -> per-frame pickles, which needs the Waymo devkit;
- ``nuscenes_data_prep --root_path R [--version V] [--nsweeps N] [--no_filter_zero]``:
  the nuScenes train / val infos (``tdal_torch.data.nuscenes.create_nuscenes_infos``),
  which needs the nuScenes devkit.

Host work only (numpy), so no ``--device``; the files equal ``tools/create_data.py``'s.
"""

import argparse

from tdal_torch.data.waymo_schema import load_pickle


def waymo_data_prep(root_path, split: str = "train", nsweeps: int = 1, gt_database: bool = True):
    from tdal_torch.data.gt_augment import create_groundtruth_database
    from tdal_torch.data.waymo_converter import create_waymo_infos

    infos = create_waymo_infos(root_path, split=split, nsweeps=nsweeps)
    if gt_database and split == "train":
        create_groundtruth_database(infos, root_path, nsweeps=nsweeps)
    return infos


def main():
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("waymo_data_prep", help="build infos (+ gt database)")
    p.add_argument("--root_path", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--nsweeps", type=int, default=1)
    p.add_argument("--no_gt_database", action="store_true")

    c = sub.add_parser("waymo_convert", help="tfrecords -> per-frame pickles (needs devkit)")
    c.add_argument("--records", nargs="+", required=True)
    c.add_argument("--out_root", required=True)
    c.add_argument("--split", default="train")

    fc = sub.add_parser("frame_cache", help="build the columnar .tdc point cache")
    fc.add_argument("--info_path", required=True)
    fc.add_argument("--no_sweeps", action="store_true")

    n = sub.add_parser("nuscenes_data_prep", help="build nuScenes infos (needs devkit)")
    n.add_argument("--root_path", required=True)
    n.add_argument("--version", default="v1.0-trainval")
    n.add_argument("--nsweeps", type=int, default=10)
    n.add_argument("--no_filter_zero", action="store_true")

    args = parser.parse_args()
    if args.cmd == "waymo_data_prep":
        waymo_data_prep(args.root_path, args.split, args.nsweeps,
                        gt_database=not args.no_gt_database)
    elif args.cmd == "waymo_convert":
        from tdal_torch.data.waymo_converter import convert_tfrecords

        convert_tfrecords(args.records, args.out_root, args.split)
    elif args.cmd == "frame_cache":
        from tdal_torch.data.frame_cache import build_cache

        n = build_cache(load_pickle(args.info_path), with_sweeps=not args.no_sweeps)
        print(f"wrote {n} .tdc files")
    elif args.cmd == "nuscenes_data_prep":
        from tdal_torch.data.nuscenes import create_nuscenes_infos

        create_nuscenes_infos(args.root_path, version=args.version, nsweeps=args.nsweeps,
                              filter_zero=not args.no_filter_zero)


if __name__ == "__main__":
    main()
