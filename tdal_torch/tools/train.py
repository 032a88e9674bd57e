"""Detector training: port of ``tools/train.py``.

Config-driven CenterPoint training: the model (PointPillars or VoxelNet), voxel
generator, assigner and OneCycle'd AdamW from the config, ``train_detector`` with a
checkpoint per epoch under ``<work_dir>/checkpoints`` and, with val infos, AP/APH every
``--val_every`` epochs; ``--profile_dir`` traces train steps 5-9. A
``TwoStageDetector`` config trains its RoI head with ``train_two_stage`` on the first
stage named by ``first_stage_cfg.pretrained`` (frozen where the config says
``freeze``).

Training is data-parallel by default, as tdal's (``tdal_torch.parallel.mesh.launch``):
under ``torchrun --nproc_per_node N -m tdal_torch.tools.train ...`` each process is one
rank; a plain launch spawns one rank per visible card; ``--no_data_parallel`` trains on
one card, and ``--device cpu`` without a launcher is one rank. The batch is global: by
default the config's ``samples_per_gpu`` times the number of ranks.

A config whose ``train_preprocessor.db_sampler`` is enabled trains with GT-aug from the
database that ``python -m tdal_torch.tools.create_data waymo_data_prep`` writes; the
log says whether the sampler is on (and for which classes) or off, and why.

``--resume_from`` takes a ``.pt`` of the port's, or a checkpoint directory that
``tdal``'s training wrote: then, as ``tdal``'s resume does, the weights and the step
come from its latest checkpoint and the optimizer starts afresh.
"""

import argparse
from pathlib import Path

from tdal_torch.convert import load_tdal_checkpoint
from tdal_torch.data.detection import DetectionDataset
from tdal_torch.data.gt_augment import build_db_sampler
from tdal_torch.data.waymo_schema import load_pickle
from tdal_torch.models.builder import (
    build_assigner, build_detector, build_test_cfg, build_two_stage_engine, build_voxel_config,
)
from tdal_torch.parallel.mesh import is_main, launch
from tdal_torch.pipeline.detector_run import train_detector
from tdal_torch.pipeline.two_stage_run import load_pretrained_first, train_two_stage
from tdal_torch.runtime.checkpoint import is_tdal_checkpoint
from tdal_torch.runtime.config import Config
from tdal_torch.runtime.logging_utils import create_logger, fix_seed, quiet_logger
from tdal_torch.runtime.schedules import adam_with_schedule, one_cycle
from tdal_torch.runtime.train_state import TrainState, param_count
from tdal_torch.tools._common import add_device


def parse_args():
    parser = argparse.ArgumentParser(description="Train a detector")
    parser.add_argument("config", help="train config file path")
    parser.add_argument("--work_dir", help="the dir to save logs and models")
    parser.add_argument("--info_path", help="override train infos path")
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--total_epochs", type=int, default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--no_data_parallel", action="store_true",
                        help="train on one device instead of one rank per card")
    parser.add_argument("--resume_from", default=None,
                        help="a checkpoint (.pt) to resume, or a checkpoint directory of "
                             "tdal's (its weights and step; the optimizer starts afresh)")
    parser.add_argument("--val_info_path", help="val infos for in-training eval "
                        "(overrides cfg.data.val.info_path)")
    parser.add_argument("--val_every", type=int, default=1, help="val every N epochs")
    parser.add_argument("--val_max_frames", type=int, default=None)
    parser.add_argument("--no_val", action="store_true", help="disable in-training val")
    parser.add_argument("--profile_dir", default=None,
                        help="write a torch.profiler trace of train steps 5-9 there")
    add_device(parser)
    return parser.parse_args()


def build_train_dataset(cfg, infos, assigner, voxel_cfg, seed: int = 0, logger=None):
    """The training ``DetectionDataset`` of ``cfg`` over ``infos``: its augmentations
    from ``cfg.train_preprocessor`` and, where its ``db_sampler`` is enabled and the
    dbinfos file exists, the GT-aug sampler (5 point features for one sweep, 6
    otherwise), as ``tools/train.py`` builds it. The dataset's draws and the sampler's
    come from ``seed``: every rank of a data-parallel run builds the same global batches."""
    pre = cfg.get("train_preprocessor", {})
    data_train = cfg.data["train"]
    nsweeps = data_train.get("nsweeps", 1)
    cfg_db = pre.get("db_sampler") or {}
    db_sampler = build_db_sampler(cfg_db, point_features=5 if nsweeps == 1 else 6, seed=seed)
    if logger is not None:
        if db_sampler is not None:
            logger.info(f"GT-aug database sampler on ({cfg_db['db_info_path']}): sample "
                        f"groups {db_sampler.sample_groups}")
        elif cfg_db.get("enable", False):
            logger.info(f"GT-aug database sampler off: its database {cfg_db['db_info_path']} "
                        f"is missing")
        else:
            logger.info("GT-aug database sampler off (not enabled in the config)")
    return DetectionDataset(
        infos, data_train["class_names"], assigner, voxel_cfg, mode="train", nsweeps=nsweeps,
        max_points=data_train.get("max_points", 200000),
        global_rot_noise=tuple(pre.get("global_rot_noise", (-0.785398, 0.785398))),
        global_scale_noise=tuple(pre.get("global_scale_noise", (0.95, 1.05))),
        shuffle_points=pre.get("shuffle_points", True), seed=seed, db_sampler=db_sampler)


def main():
    args = parse_args()
    launch(train, (args,), args.device, data_parallel=not args.no_data_parallel)


def train(mesh, args):
    """One rank's training (``mesh`` None: the only process)."""
    device = args.device if mesh is None else mesh.device
    cfg = Config.fromfile(args.config)
    work_dir = Path(args.work_dir or cfg.get("work_dir", "./work_dirs/train"))
    work_dir.mkdir(parents=True, exist_ok=True)
    logger = create_logger(work_dir / "train.log") if is_main(mesh) else quiet_logger()
    seed = fix_seed(args.seed if args.seed is not None else 0)
    if mesh is not None:
        logger.info(f"data-parallel over {mesh.world} ranks ({mesh.backend})")

    voxel_cfg = build_voxel_config(cfg.voxel_generator, train=True)
    two_stage = cfg.model["type"] == "TwoStageDetector"
    if two_stage:
        base_model_cfg = cfg.model["first_stage_cfg"]
        first = build_detector(base_model_cfg, voxel_cfg, device="cpu", seed=seed)
        model = build_two_stage_engine(cfg.model, voxel_cfg,
                                       build_test_cfg(cfg.test_cfg, first, voxel_cfg),
                                       device=device, seed=seed)
        detector = model.first
    else:
        base_model_cfg = cfg.model
        model = detector = build_detector(cfg.model, voxel_cfg, device=device, seed=seed)
    test_cfg = build_test_cfg(cfg.test_cfg, detector, voxel_cfg)
    assigner = build_assigner(cfg.train_cfg["assigner"], detector)
    data_train = cfg.data["train"]
    infos = load_pickle(args.info_path or data_train["info_path"])
    train_ds = build_train_dataset(cfg, infos, assigner, voxel_cfg, seed, logger)
    logger.info(f"{len(train_ds)} train frames")

    val_ds = None
    val_info_path = args.val_info_path or cfg.data.get("val", {}).get("info_path")
    if val_info_path and not args.no_val and not two_stage:
        val_ds = DetectionDataset(
            load_pickle(val_info_path), data_train["class_names"], assigner, voxel_cfg, mode="val",
            nsweeps=data_train.get("nsweeps", 1),
            max_points=data_train.get("max_points", 200000))
        logger.info(f"{len(val_ds)} val frames (every {args.val_every} epochs)")

    world = 1 if mesh is None else mesh.world
    batch_size = args.batch_size or cfg.data.get("samples_per_gpu", 4) * world
    total_epochs = args.total_epochs or cfg.total_epochs
    total_steps = max(1, len(train_ds) // batch_size) * total_epochs
    lr, mom = one_cycle(cfg.lr_config["lr_max"], total_steps,
                        moms=tuple(cfg.lr_config.get("moms", (0.95, 0.85))),
                        div_factor=cfg.lr_config.get("div_factor", 10.0),
                        pct_start=cfg.lr_config.get("pct_start", 0.4))
    params = model.trainable_parameters() if two_stage else model.parameters()
    opt = adam_with_schedule(params, lr, cfg.optimizer.get("wd", 0.01),
                             cfg.get("grad_clip", {}).get("max_norm"), mom)
    logger.info(f"detector params: {param_count(model)}")
    state = TrainState(model, opt)
    if two_stage:
        load_pretrained_first(model, cfg, logger)
    if args.resume_from and is_tdal_checkpoint(args.resume_from):
        meta = load_tdal_checkpoint(model, args.resume_from)
        state.step = int(meta.get("step", 0))
        logger.info(f"resumed from {args.resume_from}: {meta}")
    elif args.resume_from:
        state.load(args.resume_from)
        logger.info(f"resumed from {args.resume_from} at step {state.step}")
    if two_stage:
        train_two_stage(state, train_ds, total_epochs, batch_size, logger, work_dir, seed=seed,
                        mesh=mesh)
    else:
        head = base_model_cfg["bbox_head"]
        train_detector(state, train_ds, head.get("code_weights", [1.0] * 8), total_epochs,
                       batch_size, logger, work_dir, weight=head.get("weight", 2.0),
                       seed=seed, val_ds=val_ds, test_cfg=test_cfg, val_every=args.val_every,
                       val_max_frames=args.val_max_frames, mesh=mesh,
                       profile_dir=args.profile_dir)
    logger.info("Done.")


if __name__ == "__main__":
    main()
