"""Detector inference and evaluation: port of ``tools/dist_test.py``.

The detector over a split, in order -> ``<work_dir>/prediction.pkl`` keyed by token;
``--speed_test`` logs the middle third's seconds per frame; ``--double_flip`` runs the
four-variant flip TTA; ``--evaluate`` writes det_annos and the proto rows. The
checkpoint is a ``.pt`` of ``train``'s (or the newest one in a directory), or a
directory that ``tdal``'s ``CheckpointManager`` wrote (its latest step, read without
orbax and converted; ``tdal_torch.convert.load_tdal_checkpoint``). A
``TwoStageDetector`` config runs ``run_two_stage_inference`` (sqrt-rescored RoI head
predictions) with a two-stage checkpoint. ``--profile_dir`` traces three batches of
the middle third (``run_inference``'s hook).

``--spatial_shards N`` (N > 1) spatially partitions the BEV stack of one batch over N
ranks (tdal's ``spatial_sharding``; ``tdal_torch.parallel.mesh``): N processes of one
spatial group, over NCCL on the first N cards, or with ``--device cpu`` over gloo on the
CPU. Fewer cards than N refuse. Each rank predicts the whole batch from its rows of the
canvas; rank 0 logs and writes ``prediction.pkl``.
"""

import argparse
from pathlib import Path

import torch

from tdal_torch.data.detection import DetectionDataset
from tdal_torch.data.waymo_schema import dump_pickle, load_pickle, reorganize_info
from tdal_torch.convert import load_tdal_checkpoint
from tdal_torch.models.builder import (
    build_assigner, build_detector, build_test_cfg, build_two_stage_engine, build_voxel_config,
)
from tdal_torch.pipeline.detector_run import run_inference
from tdal_torch.pipeline.two_stage_run import run_two_stage_inference
from tdal_torch.pipeline.track_extraction import create_pd_detection
from tdal_torch.runtime.checkpoint import is_tdal_checkpoint
from tdal_torch.runtime.config import Config
from tdal_torch.parallel.mesh import is_main, spatial_sharding, spawn
from tdal_torch.runtime.logging_utils import create_logger, fix_seed, quiet_logger
from tdal_torch.runtime.train_state import TrainState, checkpoint_file
from tdal_torch.tools._common import add_device


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Test a detector")
    parser.add_argument("config", help="config file path")
    parser.add_argument("--work_dir", required=True)
    parser.add_argument("--checkpoint", required=True,
                        help="a checkpoint (.pt) of train, or its checkpoints dir (the "
                             "newest), or a checkpoint directory of tdal's (its latest step)")
    parser.add_argument("--info_path", help="override infos path")
    parser.add_argument("--split", default="val", choices=["val", "mytrain", "test", "train"])
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--speed_test", action="store_true")
    parser.add_argument("--double_flip", action="store_true", help="4-variant flip TTA")
    parser.add_argument("--evaluate", action="store_true", help="write det_annos/proto")
    parser.add_argument("--profile_dir", default=None,
                        help="write a torch.profiler trace of three middle batches there")
    parser.add_argument("--spatial_shards", type=int, default=1,
                        help="split the BEV canvas H over N ranks (one batch's RPN and "
                             "head over N cards, or N CPU processes with --device cpu)")
    add_device(parser)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    n = args.spatial_shards
    if n < 1:
        raise ValueError(f"--spatial_shards must be 1 or more, got {n}")
    if n == 1:
        return run(None, args)
    if args.device is not None and torch.device(args.device).type == "cpu":
        return spawn(run, (args,), devices=["cpu"] * n, backend="gloo", spatial=n)
    cards = torch.cuda.device_count()
    if cards < n:
        raise RuntimeError(f"--spatial_shards {n} needs {n} cards; this machine has {cards}")
    return spawn(run, (args,), devices=[f"cuda:{i}" for i in range(n)], backend="nccl",
                 spatial=n)


def run(mesh, args):
    """The test on one device (``mesh`` None) or as one rank of a spatial group."""
    cfg = Config.fromfile(args.config)
    work_dir = Path(args.work_dir)
    main = is_main(mesh)
    if main:
        work_dir.mkdir(parents=True, exist_ok=True)
    logger = create_logger(work_dir / "test.log") if main else quiet_logger()
    fix_seed(0)
    device = args.device if mesh is None else mesh.device

    voxel_cfg = build_voxel_config(cfg.voxel_generator, train=False)
    two_stage = cfg.model["type"] == "TwoStageDetector"
    if two_stage:
        first = build_detector(cfg.model["first_stage_cfg"], voxel_cfg, device="cpu")
        model = build_two_stage_engine(cfg.model, voxel_cfg,
                                       build_test_cfg(cfg.test_cfg, first, voxel_cfg),
                                       device=device)
        detector = model.first
    else:
        model = detector = build_detector(cfg.model, voxel_cfg, device=device)
    if mesh is not None:
        # the two-stage engine's first stage too: its feature map comes back whole
        detector.bev_sharding = spatial_sharding(mesh)
        logger.info(f"spatial partitioning: BEV canvas H over {mesh.spatial} devices "
                    f"({mesh.backend})")
    test_cfg = build_test_cfg(cfg.test_cfg, detector, voxel_cfg)
    assigner = build_assigner(cfg.train_cfg["assigner"], detector)
    split_key = "train" if args.split in ("train", "mytrain") else "val"
    data = cfg.data[split_key]
    infos = load_pickle(args.info_path or data["info_path"])
    ds = DetectionDataset(infos, data["class_names"], assigner, voxel_cfg, mode="val",
                          nsweeps=data.get("nsweeps", 1),
                          max_points=data.get("max_points", 200000), shuffle_points=False)
    logger.info(f"{len(ds)} frames to run")

    state = TrainState(model, None)
    if is_tdal_checkpoint(args.checkpoint):
        meta = load_tdal_checkpoint(model, args.checkpoint)
        logger.info(f"restored tdal checkpoint {args.checkpoint}: {meta}")
    else:
        ckpt = checkpoint_file(args.checkpoint)
        model.load_state_dict(torch.load(ckpt, map_location=next(model.parameters()).device,
                                         weights_only=True)["model"])
        logger.info(f"restored checkpoint: {ckpt}")
    batch_size = args.batch_size or cfg.data.get("samples_per_gpu", 4)
    if two_stage:
        detections = run_two_stage_inference(state, ds, batch_size, logger,
                                              speed_test=args.speed_test)
    else:
        detections = run_inference(state, ds, test_cfg, batch_size, logger,
                                   speed_test=args.speed_test, double_flip=args.double_flip,
                                   profile_dir=args.profile_dir if main else None, mesh=mesh)
    if not main:
        return None
    dump_pickle(detections, work_dir / "prediction.pkl")
    logger.info(f"saved prediction.pkl ({len(detections)} frames)")
    if args.evaluate:
        create_pd_detection(detections, reorganize_info(infos), work_dir, tracking=False,
                            logger=logger)


if __name__ == "__main__":
    main()
