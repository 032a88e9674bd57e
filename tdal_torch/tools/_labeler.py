"""The shared body of the labeler CLIs (static_train/static_eval, dynamic_train/
dynamic_eval): data loading, training and label emission. ``--data_parallel`` trains
over the ranks of a ``torchrun`` launch, or one rank per visible card
(``tdal_torch.parallel.mesh.launch``), with ``--batch_size`` the global batch."""

from __future__ import annotations

from pathlib import Path

from tdal_torch.data.track_datasets import (
    DynamicTrackDataset, StaticTrackDataset, preprocess_tracks,
)
from tdal_torch.data.waymo_schema import (
    AnnoStore, dump_pickle, load_pickle, reorganize_info,
)
from tdal_torch.pipeline.factories import load_track_data, make_labeler, restore_labeler_state
from tdal_torch.pipeline.labeler_run import (
    build_token2idx, postprocess_dynamic, postprocess_static, predict_final_boxes,
    sort_detections, train_labeler,
)
from tdal_torch.parallel.mesh import is_main, launch
from tdal_torch.runtime.logging_utils import create_logger, fix_seed, quiet_logger
from tdal_torch.runtime.schedules import adam_with_schedule, labeler_step_decay
from tdal_torch.runtime.train_state import TrainState, param_count

DATASETS = {"static": (StaticTrackDataset, "trackStatic"),
            "dynamic": (DynamicTrackDataset, "trackDynamic")}


def add_train_args(parser, npoints: int, n_object_points: int):
    parser.add_argument("--infos", required=True, help="Path to infos file.")
    parser.add_argument("--split", type=int, default=16, help="Number of train shards.")
    parser.add_argument("--n_epoch", type=int, default=100)
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--weight_decay", type=float, default=1e-4)
    parser.add_argument("--npoints", type=int, default=npoints)
    parser.add_argument("--n_object_points", type=int, default=n_object_points)
    parser.add_argument("--work_dir", default=None)
    parser.add_argument("--num_workers", type=int, default=0,
                        help="spawned batch-building workers (0 = in-process)")
    parser.add_argument("--data_parallel", action="store_true",
                        help="train over torchrun's ranks, or one rank per visible card")


def train(args, kind: str, model_type: str, result_dir: Path, log_file: Path):
    """static_train.py:168-230 / dynamic_train.py: the tracks, a 90/10 split, AdamW on
    the step decay, ``train_labeler`` with the best checkpoint in ``result_dir``, on
    one device or, with ``--data_parallel``, over ranks (rank 0 logs to ``log_file``)."""
    launch(_train_rank, (args, kind, model_type, result_dir, log_file), args.device,
           data_parallel=args.data_parallel)


def _train_rank(mesh, args, kind: str, model_type: str, result_dir: Path, log_file: Path):
    fix_seed(args.seed)
    logger = create_logger(log_file) if is_main(mesh) else quiet_logger()
    device = args.device if mesh is None else mesh.device
    dataset_cls, prefix = DATASETS[kind]
    logger.info("Load track data")
    track = load_track_data(args.track, args.split, prefix=prefix)
    logger.info(f"{len(track)} tracks")
    annos = AnnoStore(reorganize_info(load_pickle(args.infos)))
    train_track, val_track = preprocess_tracks(track, annos, ratio=0.1, seed=args.seed)
    train_ds = dataset_cls(train_track, annos, npoints=args.npoints, seed=args.seed)
    val_ds = dataset_cls(val_track, annos, npoints=args.npoints, seed=args.seed + 1)
    logger.info(f"train samples: {len(train_ds)}, val samples: {len(val_ds)}")

    model, loss_fn, inputs_fn, _ = make_labeler(model_type, args.n_object_points,
                                                device=device, seed=args.seed)
    logger.info(f"model params: {param_count(model)}")
    steps_per_epoch = max(1, len(train_ds) // args.batch_size)
    opt = adam_with_schedule(model.parameters(), labeler_step_decay(args.lr, steps_per_epoch),
                             weight_decay=args.weight_decay)
    logger.info("Start training")
    _, best = train_labeler(model, loss_fn, inputs_fn, TrainState(model, opt), train_ds,
                            val_ds, n_epoch=args.n_epoch, batch_size=args.batch_size,
                            logger=logger, ckpt_dir=result_dir, seed=args.seed,
                            num_workers=args.num_workers, mesh=mesh)
    logger.info(f"Best: {best}")
    logger.info("Done.")


def evaluate(args, kind: str, model_type: str, out_path: Path, logger):
    """static_eval.py:292-352 / dynamic_eval.py: the trained labeler over every
    matched track, its metrics, and the patched det_annos in ``out_path``."""
    dataset_cls, prefix = DATASETS[kind]
    if kind == "static":  # tools/dynamic_eval.py logs no such line
        logger.info("Load track data")
    track = load_track_data(args.track, prefix=prefix)
    info_map = reorganize_info(load_pickle(args.infos))
    annos = AnnoStore(info_map)
    det_annos, token2idx = None, None
    if args.det_annos:
        det_annos = sort_detections(load_pickle(args.det_annos))
        token2idx = build_token2idx(info_map, annos, det_annos)
    track, _ = preprocess_tracks(track, annos, ratio=0.0, seed=args.seed)
    test_ds = dataset_cls(track, annos, npoints=args.npoints, seed=args.seed)
    model, _, inputs_fn, decode_kind = make_labeler(model_type, args.n_object_points,
                                                    device=args.device)
    # tools/*_eval.py draw the first sample to initialise their model, which moves the
    # dataset's generator on: drawing it too keeps the same points in every sample
    if len(test_ds):
        test_ds[0]
    model, meta = restore_labeler_state(model, args.model_path)
    logger.info(f"Loaded checkpoint meta: {meta}")
    logger.info("Start testing")
    final = predict_final_boxes(model, test_ds, inputs_fn, decode_kind, args.batch_size,
                                device=args.device)
    logger.info("Start post processing")
    post = postprocess_static if kind == "static" else postprocess_dynamic
    post(track, annos, final, logger, det_annos, token2idx, device=args.device)
    if det_annos is not None:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        dump_pickle(det_annos, out_path)
        logger.info(f"Saved patched det_annos to {out_path}")
