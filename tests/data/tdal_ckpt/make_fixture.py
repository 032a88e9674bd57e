"""Write the committed tdal checkpoint fixture beside this file.

Run from the repository root, on a machine with jax, flax and orbax:

    python tests/data/tdal_ckpt/make_fixture.py

It builds the narrow PointPillars of ``pp_narrow.py`` with tdal, fills its parameter
and batch-statistics trees (shapes from ``jax.eval_shape`` of its init) with seeded
values, and writes through tdal's own code:

- ``ckpt/``: a ``CheckpointManager`` directory with two steps (step 1 marked best,
  step 2 the latest) and their ``meta.json``;
- ``legacy/``: step 2's tree in the pre-FusedConvBN layout (``Conv_N`` + ``BatchNorm_N``
  where the tree has a ``FusedConvBN_N`` without conv bias), which tdal's
  ``migrate_legacy_conv_params`` turns back into step 2's tree (checked here);
- ``tree.npz``: step 2's tree flattened on ``/``;
- ``expected.npz``: every leaf of both steps (``step2/...``, ``step1/...``), and on the
  two frames of ``fixture_frames`` (made by ``make_synthetic_dataset``) tdal's head maps
  (``maps/<task>/<name>``, eval forward), its predict step's outputs (``predict/...``)
  and ``run_inference``'s per-frame detections (``pred/<token>/...``), as
  ``tools/dist_test.py`` computes them from ``ckpt/``.

The values are sparse and quantised, so that the four copies of the 218,201 values fit
in about 200 KB: each kernel has about ``NONZERO`` entries set, to an integer in
[-8, 8] times a power of two that keeps each output's scale near 1; biases and means
are multiples of 1/16, scales of 1/16 in [0.5, 1.5], running variances multiples of 1/8
in [0.5, 2]; the heatmap's final bias is 0 and its final kernel is ``HM_GAIN`` times
larger, so that its logits spread. The fixture is
small; the tests hold the reader at full width on checkpoints they write themselves.
"""

import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from tdal.data.detection import DetectionDataset  # noqa: E402
from tdal.data.synthetic import make_synthetic_dataset  # noqa: E402
from tdal.models.builder import (  # noqa: E402
    build_assigner, build_detector, build_test_cfg, build_voxel_config,
)
from tdal.pipeline.detector_engine import make_detector_steps  # noqa: E402
from tdal.pipeline.detector_run import run_inference  # noqa: E402
from tdal.runtime.checkpoint import CheckpointManager, migrate_legacy_conv_params  # noqa: E402
from tdal.runtime.config import Config  # noqa: E402
from tdal.runtime.logging_utils import create_logger  # noqa: E402
from tdal.runtime.train_state import TrainState  # noqa: E402

CONFIG = HERE / "pp_narrow.py"
NONZERO = 1500  # entries set in each kernel (all of a smaller one)
HM_GAIN = 128.0


def seeded_tree(shapes, seed):
    """Sparse quantised values of ``shapes``' leaves, by leaf name."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['var']"):
            return (rng.integers(4, 17, s.shape) / 8).astype(np.float32)
        if name.endswith("['scale']"):
            return (rng.integers(8, 25, s.shape) / 16).astype(np.float32)
        if "final_conv_bias" in name:
            return np.zeros(s.shape, np.float32)
        if len(s.shape) == 1:  # biases and means: every entry set, smaller
            return (rng.integers(-4, 5, s.shape) / 16).astype(np.float32)
        size = int(np.prod(s.shape))
        fan_in = size // s.shape[-1]
        v = rng.integers(1, 9, s.shape) * rng.choice([-1, 1], s.shape)
        v = v * (rng.random(s.shape) < min(1.0, NONZERO / size))
        # keep each output's scale near 1 over the entries that are set
        scale = 1.0 / max(1.0, np.sqrt(fan_in * min(1.0, NONZERO / size)) * 4)
        return (v * np.exp2(np.round(np.log2(scale))) / 4).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    # spread the heatmap's logits (its columns come last), so that scores rarely tie
    sep = tree["params"]["CenterHead_0"]["SepHead_0"]
    sep["final_conv_kernel"][..., -1:] *= HM_GAIN
    return {"params": tree["params"], "batch_stats": tree["batch_stats"]}


def unmigrate(tree):
    """The legacy layout of ``tree``: each FusedConvBN_N without conv bias becomes
    Conv_N {kernel} + BatchNorm_N {scale, bias}, its statistics BatchNorm_N."""
    renamed = []

    def walk(node, path):
        out = {}
        for k, v in node.items():
            if k.startswith("FusedConvBN_") and "conv_bias" not in v:
                idx = k.split("_", 1)[1]
                out[f"Conv_{idx}"] = {"kernel": v["kernel"]}
                out[f"BatchNorm_{idx}"] = {"scale": v["scale"], "bias": v["bias"]}
                renamed.append((path, k, f"BatchNorm_{idx}"))
            elif isinstance(v, dict):
                out[k] = walk(v, path + (k,))
            else:
                out[k] = v
        return out

    params = walk(tree["params"], ())
    stats = jax.tree_util.tree_map(lambda x: x, tree["batch_stats"])
    for path, old, new in renamed:
        node = stats
        for p in path:
            node = node[p]
        node[new] = node.pop(old)
    return {"params": params, "batch_stats": stats}


def flat(tree, prefix=""):
    return {prefix + "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def main():
    cfg = Config.fromfile(str(CONFIG))
    vox = build_voxel_config(cfg.voxel_generator, train=False)
    det = build_detector(cfg.model, vox)
    shapes = jax.eval_shape(lambda p: det.init({"params": jax.random.PRNGKey(0)}, p),
                            jax.ShapeDtypeStruct((1, 1000, 5), jnp.float32))
    step1, step2 = seeded_tree(shapes, 1), seeded_tree(shapes, 2)
    legacy = unmigrate(step2)
    assert flat(migrate_legacy_conv_params(legacy)).keys() == flat(step2).keys()
    for k, v in flat(migrate_legacy_conv_params(legacy)).items():
        np.testing.assert_array_equal(v, flat(step2)[k])

    for name in ("ckpt", "legacy"):
        shutil.rmtree(HERE / name, ignore_errors=True)
    mgr = CheckpointManager(HERE / "ckpt")
    mgr.save(1, step1, meta={"epoch": 1, "eval_acc": 0.75}, is_best=True)
    mgr.save(2, step2, meta={"epoch": 2, "eval_acc": 0.5})
    CheckpointManager(HERE / "legacy").save(2, legacy, meta={"epoch": 2})
    np.savez_compressed(HERE / "tree.npz", **flat(step2))

    expected = {**flat(step2, "step2/"), **flat(step1, "step1/")}
    with tempfile.TemporaryDirectory() as tmp:
        infos, _ = make_synthetic_dataset(Path(tmp) / "frames", **cfg.fixture_frames)
        data = cfg.data["val"]
        test_cfg = build_test_cfg(cfg.test_cfg, det, vox)
        ds = DetectionDataset(infos, class_names=data["class_names"],
                              assigner=build_assigner(cfg.train_cfg["assigner"], det),
                              voxel_cfg=vox, mode="val", max_points=data["max_points"],
                              shuffle_points=False)
        tree, _ = CheckpointManager(HERE / "ckpt").restore(target=step2)
        state = TrainState.create(tree["params"], optax.adam(1e-3), tree["batch_stats"])
        points = jnp.asarray(np.stack([ds[i]["points"] for i in range(len(ds))]))
        maps = det.apply({"params": state.params, "batch_stats": state.batch_stats},
                         points, False)
        for t, task in enumerate(maps):
            for k, v in task.items():
                expected[f"maps/{t}/{k}"] = np.asarray(v)
        code_weights = cfg.model["bbox_head"]["code_weights"]
        _, predict = make_detector_steps(det, test_cfg, code_weights, donate=False)
        for k, v in predict(state, points).items():
            expected[f"predict/{k}"] = np.asarray(v)
        preds = run_inference(det, state, ds, test_cfg, code_weights, 2,
                              create_logger(None, name="fixture"))
        for token, d in preds.items():
            for k, v in d.items():
                expected[f"pred/{token}/{k}"] = np.asarray(v)
    np.savez_compressed(HERE / "expected.npz", **expected)
    total = sum(p.stat().st_size for p in HERE.rglob("*") if p.is_file())
    print(f"fixture written: {total} bytes under {HERE}")


if __name__ == "__main__":
    main()
