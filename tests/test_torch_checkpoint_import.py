"""The import of tdal's checkpoints: ``tdal_torch.runtime.orbax_format`` (OCDBT, zarr v2
and orbax's ``_METADATA``, through the port's zstd decoder) and
``tdal_torch.runtime.checkpoint`` against ``tdal.runtime.checkpoint`` on the same
directories, and the CLIs that take tdal's directories.

- Every leaf the port reads is bit-equal to what tdal's ``CheckpointManager.restore``
  returns: on ``tests/test_runtime.py``'s trees (sync and async saves, with bool, int,
  bf16 and scalar leaves), and at full width on the parameter and batch-statistics
  trees of the Waymo PP detector (``configs/waymo/pp/waymo_centerpoint_pp_two_pfn_
  stride1_3x.py``, read in at most 30 s) and of the two-box static labeler (shapes from
  ``jax.eval_shape`` of their init, seeded values). Each tree converts to the same
  state dict as the in-memory tree, and so do VoxelNet, the two-stage detector, the
  RoI head and the dynamic labeler at their converter tests' widths.
- The OCDBT and zarr readers against tensorstore on interior b-tree nodes, several
  chunks an array, missing chunks, both orders, fill values and dtypes; fields the
  reader does not know raise ``ValueError`` naming them.
- ``load_checkpoint_uri``, ``migrate_legacy_conv_params``, ``load_params_tolerant`` and
  the async ``CheckpointManager`` against tdal's on ``tests/test_runtime.py``'s cases
  (the loud rename error and the cache hit included).
- ``dist_test`` and ``static_eval`` / ``dynamic_eval`` on tdal directories against
  ``tools/`` on the same directories (detections within 1e-4, the same log lines),
  ``train --resume_from`` and ``first_stage_cfg.pretrained`` from tdal directories.
- The committed fixture ``tests/data/tdal_ckpt`` (``chip_smoke.py`` phase 13) reads and
  serves on the CPU as phase 13 holds it on the card.
"""

import json
import logging
import os
import pickle
import re
import shutil
import subprocess
import sys
import tarfile
import time
import types
from pathlib import Path

import numpy as np
import pytest
import tensorstore as ts
import torch

import jax
import jax.numpy as jnp

from tdal.core.voxel import VoxelConfig as JVoxelConfig
from tdal.data.synthetic import SyntheticScene as JScene
from tdal.data.synthetic import make_synthetic_dataset as jmake_synthetic_dataset
from tdal.models import two_stage as J
from tdal.models.builder import build_detector as jbuild_detector
from tdal.models.builder import build_test_cfg as jbuild_test_cfg
from tdal.models.builder import build_two_stage_engine as jbuild_two_stage_engine
from tdal.models.builder import build_voxel_config as jbuild_voxel_config
from tdal.models.detectors import VoxelNet as JVoxelNet
from tdal.pipeline.factories import make_labeler as jmake_labeler
from tdal.runtime import checkpoint as jck
from tdal.runtime.config import Config as JConfig
from tdal_torch.convert import (
    flax_to_state_dict, load_flax_two_stage, load_tdal_checkpoint, pointpillars_state_dict,
    roi_head_state_dict, voxelnet_state_dict,
)
from tdal_torch.core.voxel import VoxelConfig
from tdal_torch.data.synthetic import make_synthetic_dataset
from tdal_torch.data.waymo_schema import dump_pickle, load_pickle
from tdal_torch.models import two_stage as T
from tdal_torch.models.builder import (
    build_detector, build_test_cfg, build_two_stage_engine, build_voxel_config,
)
from tdal_torch.models.detectors import VoxelNet
from tdal_torch.pipeline.factories import make_labeler, restore_labeler_state
from tdal_torch.pipeline.two_stage_run import load_pretrained_first
from tdal_torch.runtime import checkpoint as tck
from tdal_torch.runtime import orbax_format
from tdal_torch.runtime.config import Config
from test_torch_cli_chain import CPU, _run_port, _run_tdal
from test_torch_fused_pointnet import flax_variables

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "data" / "tdal_ckpt"
PP_WAYMO = "configs/waymo/pp/waymo_centerpoint_pp_two_pfn_stride1_3x.py"
PP_TINY = "configs/synthetic/pp_tiny.py"
TWO_STAGE_TINY = "configs/synthetic/pp_two_stage_tiny.py"
READ_SECONDS = 30.0  # the reader's bound for the Waymo PP state on this image
DET_TOL = 1e-4  # detections: |port - tdal| <= DET_TOL * max(1, |tdal|), f32 on the CPU


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _leaf_bytes(x):
    """(dtype name, shape, raw bytes) of a numpy, jax or torch leaf."""
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.bfloat16
        return "bfloat16", tuple(x.shape), x.view(torch.int16).numpy().tobytes()
    a = np.asarray(x)
    return str(a.dtype), a.shape, a.tobytes()


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], prefix + (key,)).items()}
    return {prefix: tree}


def assert_bit_equal(got, want):
    fg, fw = _flat(got), _flat(want)
    assert fg.keys() == fw.keys(), sorted(fg.keys() ^ fw.keys())[:6]
    for k in fw:
        assert _leaf_bytes(fg[k]) == _leaf_bytes(fw[k]), k


def assert_same_state(a: dict, b: dict):
    assert a.keys() == b.keys(), sorted(a.keys() ^ b.keys())[:6]
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def seeded(shapes, seed):
    """Seeded numpy values of ``shapes``' leaves: He-normal kernels, BatchNorm scales
    and variances in [0.5, 1.5], biases and means in [-0.3, 0.3]."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith(("['var']", "['scale']")):
            v = rng.uniform(0.5, 1.5, s.shape)
        elif len(s.shape) <= 1:
            v = rng.uniform(-0.3, 0.3, s.shape)
        else:
            v = rng.standard_normal(s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))
        return v.astype(s.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def variables(shapes, seed) -> dict:
    tree = seeded(shapes, seed)
    return {"params": tree["params"], "batch_stats": tree.get("batch_stats", {})}


def save_tdal(directory, tree, step=1, meta=None, best=False):
    jck.CheckpointManager(directory).save(step, tree, meta=meta or {"epoch": step},
                                          is_best=best)
    return Path(directory)


def detector_shapes(config, points=(1, 1000, 5)):
    jcfg = JConfig.fromfile(str(ROOT / config))
    jdet = jbuild_detector(jcfg.model, jbuild_voxel_config(jcfg.voxel_generator, train=False))
    return jax.eval_shape(lambda p: jdet.init({"params": jax.random.PRNGKey(0)}, p),
                          jax.ShapeDtypeStruct(points, jnp.float32))


def labeler_shapes(kind, n_object_points=None):
    model = jmake_labeler(kind, n_object_points)[0]
    if kind == "dynamic":
        inputs = [(2, 320, 4), (2, 101, 8), (2, 7)]
    else:
        inputs = [(2, 256, 3), (2, 7), (2, 7)]
    key = jax.random.PRNGKey(0)
    return jax.eval_shape(
        lambda *a: model.init({"params": key, "gather": key, "dropout": key}, *a),
        *[jax.ShapeDtypeStruct(s, jnp.float32) for s in inputs])


# ---------------------------------------------------------------------------
# the reader against tdal's restore
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_async", [False, True], ids=["sync", "async"])
def test_reader_matches_tdal_restore_on_runtime_trees(tmp_path, use_async):
    """``tests/test_runtime.py``'s trees, and every dtype orbax writes for them, through
    tdal's manager (GC, best marker, async commits) and the port's ``restore_tdal``
    with tdal's step choice."""
    rng = np.random.default_rng(0)

    def tree(step):
        return {"params": {"w": jnp.arange(4.0) * step,
                           "Conv_0": {"kernel": rng.standard_normal((3, 3, 4, 8))
                                      .astype(np.float32)}},
                "step": np.int32(step), "flags": np.array([True, False, step % 2 == 0]),
                "ids": np.arange(5, dtype=np.int64) * step, "i32": np.arange(7, dtype=np.int32),
                "half": jnp.arange(6, dtype=jnp.bfloat16) * step,
                "big": rng.standard_normal((300, 400)).astype(np.float32)}

    mgr = jck.CheckpointManager(tmp_path / "ck", max_to_keep=2, use_async=use_async)
    for step, acc in ((1, 0.5), (2, 0.9), (3, 0.7), (4, 0.6)):
        mgr.save(step, tree(step), meta={"acc": acc}, is_best=step == 2)
    mgr.wait()
    assert sorted(mgr.all_steps()) == [2, 3, 4]
    for step in (2, 3, 4):
        want, want_meta = mgr.restore(step)
        got, meta = tck.restore_tdal(tmp_path / "ck", step)
        assert_bit_equal(got, want)
        assert meta == want_meta
    got, meta = tck.restore_tdal(tmp_path / "ck")
    assert meta["step"] == mgr.latest_step() == 4
    got, meta = tck.restore_tdal(tmp_path / "ck", prefer_best=True)
    assert meta == {"acc": 0.9, "step": 2} and mgr.best_step() == 2
    assert_bit_equal(got, mgr.restore(2)[0])
    got, meta = tck.restore_tdal(tmp_path / "ck" / "ckpt_00000003")
    assert meta["step"] == 3 and int(got["step"]) == 3
    # a marker whose step is gone is passed over, as tdal's latest_step does
    (tmp_path / "ck" / "latest.json").write_text(json.dumps({"step": 9}))
    assert tck.restore_tdal(tmp_path / "ck")[1]["step"] == mgr.latest_step() == 4
    with pytest.raises(FileNotFoundError):
        tck.restore_tdal(tmp_path / "empty")


@pytest.mark.parametrize("family", ["waymo_pp", "two_box_static"])
def test_full_width_states_read_bit_equal_and_convert(tmp_path, family):
    """The production models' whole saved state through tdal's save and the port's
    reader: bit-equal to tdal's restore, the Waymo PP state read within READ_SECONDS,
    and the same state dict as from the in-memory tree (the CLIs' path,
    ``load_tdal_checkpoint``, included)."""
    if family == "waymo_pp":
        tree = variables(detector_shapes(PP_WAYMO), seed=3)
        cfg = Config.fromfile(str(ROOT / PP_WAYMO))
        model = build_detector(cfg.model, build_voxel_config(cfg.voxel_generator, train=False),
                               device="cpu")
        convert = pointpillars_state_dict
    else:
        tree = variables(labeler_shapes("two_box_est"), seed=4)
        model = make_labeler("two_box_est", device="cpu")[0]
        convert = flax_to_state_dict
    n, n_state = (sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(t))
                  for t in (tree["params"], tree))
    assert (n, n_state) == {"waymo_pp": (5_249_355, 5_256_203),  # parameters, + statistics
                            "two_box_static": (2_070_736, 2_082_640)}[family]
    directory = save_tdal(tmp_path / "ck", tree, step=7)
    t0 = time.perf_counter()
    got, meta = tck.restore_tdal(directory)
    seconds = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in (directory / "ckpt_00000007").rglob("*")
                 if f.is_file())
    print(f"{family}: read {n_state} values ({nbytes} bytes on disk) in {seconds:.2f} s, "
          f"{nbytes / seconds / 1e6:.2f} MB/s, on {os.cpu_count()} cores (one used)")
    if family == "waymo_pp":
        assert seconds <= READ_SECONDS
    want, want_meta = jck.CheckpointManager(directory).restore()
    assert_bit_equal(got, want)
    assert meta == want_meta == {"epoch": 7, "step": 7}
    expect = convert(model, tree["params"], tree["batch_stats"])
    load_tdal_checkpoint(model, directory)  # migrate_legacy_conv_params, then convert
    state = model.state_dict()
    assert_same_state({k: state[k] for k in expect}, expect)


def _voxelnet_case():
    vox = ((-8, -8, -2, 8, 8, 4.0), (1.0, 1.0, 0.75), 5, 256)
    tasks = [dict(num_class=1, class_names=("VEHICLE",))]
    tiny = dict(rpn_layer_nums=(1,), rpn_ds_strides=(1,), rpn_ds_filters=(8,),
                rpn_us_strides=(1,), rpn_us_filters=(8,))
    jdet = JVoxelNet(voxel_cfg=JVoxelConfig(*vox), tasks=tuple(tasks), sparse_middle=True,
                     **tiny)
    shapes = jax.eval_shape(lambda p: jdet.init(jax.random.PRNGKey(0), p, False),
                            jax.ShapeDtypeStruct((2, 256, 5), jnp.float32))
    model = VoxelNet(VoxelConfig(*vox), tasks, sparse_middle=True, **tiny)
    return shapes, model, lambda m, t: voxelnet_state_dict(m, t["params"], t["batch_stats"])


def _roi_head_case():
    jhead = J.RoIHead(shared_fc=(32, 32), cls_fc=(16, 16), reg_fc=(16,), code_size=7)
    shapes = jax.eval_shape(
        lambda x: jhead.init({"params": jax.random.PRNGKey(5),
                              "dropout": jax.random.PRNGKey(1)}, x),
        jax.ShapeDtypeStruct((2, 12, 20), jnp.float32))
    head = T.RoIHead(20, shared_fc=(32, 32), cls_fc=(16, 16), reg_fc=(16,), code_size=7)
    return shapes, head, lambda m, t: roi_head_state_dict(m, t["params"], t["batch_stats"])


def _two_stage_case():
    jcfg, cfg = JConfig.fromfile(str(ROOT / TWO_STAGE_TINY)), Config.fromfile(
        str(ROOT / TWO_STAGE_TINY))
    jvox = jbuild_voxel_config(jcfg.voxel_generator, train=True)
    jfirst = jbuild_detector(jcfg.model["first_stage_cfg"], jvox)
    jengine = jbuild_two_stage_engine(jcfg.model, jvox,
                                      jbuild_test_cfg(jcfg.test_cfg, jfirst, jvox))
    params, bs = jax.eval_shape(jengine.init, jax.random.PRNGKey(0),
                                jax.ShapeDtypeStruct((2, 1000, 5), jnp.float32),
                                jax.ShapeDtypeStruct((2, 50, 10), jnp.float32))
    vox = build_voxel_config(cfg.voxel_generator, train=True)
    first = build_detector(cfg.model["first_stage_cfg"], vox, device="cpu")
    engine = build_two_stage_engine(cfg.model, vox, build_test_cfg(cfg.test_cfg, first, vox),
                                    device="cpu")

    def convert(m, t):
        load_flax_two_stage(m, t["params"], t["batch_stats"])
        return dict(m.state_dict())

    return {"params": params, "batch_stats": bs}, engine, convert


def _dynamic_case():
    model = make_labeler("dynamic", device="cpu")[0]
    return labeler_shapes("dynamic"), model, lambda m, t: flax_to_state_dict(
        m, t["params"], t["batch_stats"])


@pytest.mark.parametrize("family", ["voxelnet", "roi_head", "two_stage", "dynamic_labeler"])
def test_other_families_round_trip(tmp_path, family):
    """VoxelNet (sparse backbone), the RoI head, the two-stage engine (pp_two_stage_tiny)
    and the dynamic labeler at their converter tests' widths: bit-equal reads and the
    same state dict as from the in-memory tree."""
    shapes, model, convert = {"voxelnet": _voxelnet_case, "roi_head": _roi_head_case,
                              "two_stage": _two_stage_case,
                              "dynamic_labeler": _dynamic_case}[family]()
    tree = variables(shapes, seed=6)
    directory = save_tdal(tmp_path / "ck", tree)
    got, _ = tck.restore_tdal(directory)
    assert_bit_equal(got, jck.CheckpointManager(directory).restore()[0])
    expect = {k: v.clone() for k, v in convert(model, tree).items()}
    assert_same_state({k: v.clone() for k, v in
                       convert(model, tck.migrate_legacy_conv_params(got)).items()}, expect)


# ---------------------------------------------------------------------------
# OCDBT and zarr against tensorstore
# ---------------------------------------------------------------------------

ARRAYS = [  # (name, dtype, shape, chunks, order, fill_value, compressor, separator)
    ("f4_multi", "<f4", (7, 10), (3, 4), "C", None, {"id": "zstd", "level": 3}, "."),
    ("f4_fortran_nan", "<f4", (5, 6, 4), (2, 6, 3), "F", "NaN", {"id": "zstd", "level": 1}, "/"),
    ("i4_fill", "<i4", (9,), (4,), "C", 3, None, "."),
    ("i8", "<i8", (4, 4), (4, 4), "C", 0, {"id": "zstd", "level": 19}, "."),
    ("bf16", "bfloat16", (6, 5), (4, 2), "C", None, {"id": "zstd", "level": 1}, "."),
    ("bool", "|b1", (11,), (5,), "C", None, None, "."),
    ("f8", "<f8", (3, 3), (2, 2), "F", None, {"id": "zstd", "level": 1}, "."),
    ("u2_big_endian", ">u2", (13,), (13,), "C", 7, None, "."),
    ("scalar", "<f4", (), (), "C", None, {"id": "zstd", "level": 1}, "."),
]


def _ts_array(root, name, dtype, shape, chunks, order, fill, comp, sep, data, region):
    spec = {"driver": "zarr",
            "kvstore": {"driver": "ocdbt", "base": f"file://{root}/", "path": f"{name}/",
                        "config": {"max_decoded_node_bytes": 400,
                                   "max_inline_value_bytes": 24}},
            "metadata": {"shape": list(shape), "chunks": list(chunks), "dtype": dtype,
                         "order": order, "fill_value": fill, "compressor": comp,
                         "dimension_separator": sep},
            "create": True, "delete_existing": False}
    arr = ts.open(spec).result()
    arr[region].write(data[region]).result()
    return np.asarray(arr.read().result())


def test_ocdbt_and_zarr_readers_match_tensorstore(tmp_path):
    """Arrays that tensorstore writes into one OCDBT database whose small nodes force
    interior b-tree levels: several chunks an array and a chunk never written (read as
    the fill value), both orders, ``/`` and ``.`` separators, compressed and raw
    chunks, fill values null, NaN and integers, and the dtypes orbax writes."""
    rng = np.random.default_rng(0)
    want = {}
    for name, dtype, shape, chunks, order, fill, comp, sep in ARRAYS:
        np_dtype = np.uint16 if dtype == "bfloat16" else np.dtype(dtype)
        data = (rng.standard_normal(shape) * 100).astype(np_dtype) if np_dtype != bool \
            else rng.random(shape) < 0.5
        if dtype == "bfloat16":
            import ml_dtypes

            data = rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
        region = tuple(slice(0, max(1, s - 2)) for s in shape)  # leaves the far chunks out
        want[name] = _ts_array(tmp_path, name, dtype, shape, chunks, order, fill, comp, sep,
                               data, region)
    kv = orbax_format.OcdbtDatabase(tmp_path)
    items = kv.items()
    store = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/"}).result()
    keys = store.list().result()
    assert sorted(items) == sorted(keys)
    for k in keys:
        assert items[k] == store.read(k).result().value
    for name, dtype, *_ in ARRAYS:
        got = orbax_format.read_zarr(items, name)
        if dtype == "bfloat16":
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want[name].view(np.int16))
        else:
            assert got.dtype == want[name].dtype.newbyteorder("="), name
            np.testing.assert_array_equal(got, want[name], err_msg=name)


def _step_dir(tmp_path):
    directory = save_tdal(tmp_path / "ck", {"params": {"w": np.arange(4.0, dtype=np.float32)}})
    return directory / "ckpt_00000001"


@pytest.mark.parametrize("case", ["use_zarr3", "use_ocdbt", "value_type", "key", "crc32c",
                                  "compressor", "filters", "no manifest"])
def test_reader_refuses_what_it_does_not_know(tmp_path, case):
    """Every field outside what this orbax version writes raises a ValueError that
    names it; a damaged node fails its crc32c."""
    step = _step_dir(tmp_path)
    meta_path = step / "_METADATA"
    meta = json.loads(meta_path.read_text())
    (key, leaf), = meta["tree_metadata"].items()
    if case in ("use_zarr3", "use_ocdbt"):
        meta[case] = case == "use_zarr3"
    elif case == "value_type":
        leaf["value_metadata"]["value_type"] = "scalar"
    elif case == "key":
        meta["tree_metadata"] = {"__import__('os')": leaf}
    elif case in ("compressor", "filters"):
        kv = orbax_format.OcdbtDatabase(step).items()
        zarray = json.loads(kv[b"params.w/.zarray"])
        zarray[case] = {"id": "blosc"} if case == "compressor" else [{"id": "delta"}]
        kv[b"params.w/.zarray"] = json.dumps(zarray).encode()
        with pytest.raises(ValueError, match=case):
            orbax_format.read_zarr(kv, "params.w")
        return
    elif case == "crc32c":
        manifest = step / "manifest.ocdbt"
        raw = bytearray(manifest.read_bytes())
        raw[20] ^= 0x10
        manifest.write_bytes(bytes(raw))
    else:
        (step / "manifest.ocdbt").unlink()
        shutil.rmtree(step / "ocdbt.process_0")
    meta_path.write_text(json.dumps(meta))
    match = {"key": "tree_metadata key", "no manifest": "OCDBT manifest"}.get(case, case)
    with pytest.raises(ValueError, match=match):
        orbax_format.read_step_dir(step)


# ---------------------------------------------------------------------------
# load_checkpoint_uri, migration, tolerant loading, the async manager
# ---------------------------------------------------------------------------


def test_load_checkpoint_uri_matches_tdal(tmp_path):
    """``tests/test_runtime.py``'s zoo flow through both packages: a ``file://``
    tarball (then from the cache, with the tarball gone), a ``.npz`` by URL and by
    path, a local directory of either package, and a hostile archive refused."""
    tree = {"params": {"w": jnp.arange(4.0)}}
    save_tdal(tmp_path / "zoo_ckpt", tree, step=7, meta={"acc": 1.0})
    tarball = tmp_path / "zoo.tar.gz"
    with tarfile.open(tarball, "w:gz") as tf:
        tf.add(tmp_path / "zoo_ckpt", arcname="zoo_ckpt")
    uri = f"file://{tarball}"
    want, want_meta = jck.load_checkpoint_uri(uri, cache_dir=tmp_path / "jcache")
    got, meta = tck.load_checkpoint_uri(uri, cache_dir=tmp_path / "cache")
    assert_bit_equal(got, want)
    assert meta == want_meta == {"acc": 1.0, "step": 7}
    cached = sorted(p.name for p in (tmp_path / "cache").iterdir())
    assert cached == sorted(p.name for p in (tmp_path / "jcache").iterdir())  # sha256[:16]
    tarball.unlink()  # a cache hit reads nothing from the URL
    assert_bit_equal(tck.load_checkpoint_uri(uri, cache_dir=tmp_path / "cache")[0], want)

    np.savez(tmp_path / "flat.npz", **{"params/w": np.arange(3.0), "params/sub/b": np.ones(2)})
    for src in (f"file://{tmp_path}/flat.npz", str(tmp_path / "flat.npz")):
        got, meta = tck.load_checkpoint_uri(src, cache_dir=tmp_path / "cache")
        assert_bit_equal(got, jck.load_checkpoint_uri(f"file://{tmp_path}/flat.npz",
                                                      cache_dir=tmp_path / "jcache")[0])
        assert meta == {}
    got, meta = tck.load_checkpoint_uri(str(tmp_path / "zoo_ckpt"))
    assert_bit_equal(got, jck.load_checkpoint_uri(str(tmp_path / "zoo_ckpt"))[0])
    mgr = tck.CheckpointManager(tmp_path / "port_ckpt")
    mgr.save(3, {"model": {"w": torch.arange(3.0)}}, meta={"acc": 0.2})
    got, meta = tck.load_checkpoint_uri(str(tmp_path / "port_ckpt"))
    assert torch.equal(got["model"]["w"], torch.arange(3.0)) and meta == {"acc": 0.2, "step": 3}

    evil = tmp_path / "evil.tar.gz"
    payload = tmp_path / "payload"
    payload.write_text("x")
    with tarfile.open(evil, "w:gz") as tf:
        tf.add(payload, arcname="../escaped")
    for load in (jck.load_checkpoint_uri, tck.load_checkpoint_uri):
        with pytest.raises(tarfile.FilterError):
            load(f"file://{evil}", cache_dir=tmp_path / "evil_cache")
    assert not (tmp_path / "evil_cache" / "escaped").exists()


def _legacy_cases():
    k = np.arange(3 * 3 * 4 * 8, dtype=np.float32).reshape(3, 3, 4, 8)
    full = lambda n, v: np.full(n, v, np.float32)  # noqa: E731
    legacy = {
        "params": {"rpn": {"block0": {
            "Conv_0": {"kernel": k},
            "BatchNorm_0": {"scale": full(8, 2.0), "bias": full(8, 3.0)},
            "Conv_1": {"kernel": k, "bias": full(8, 0.0)}}}},
        "batch_stats": {"rpn": {"block0": {"BatchNorm_0": {"mean": full(8, 5.0),
                                                           "var": full(8, 7.0)}}}},
    }
    target = {
        "params": {"rpn": {"block0": {
            "FusedConvBN_0": {"kernel": np.zeros_like(k), "scale": full(8, 1.0),
                              "bias": full(8, 0.0)},
            "Conv_1": {"kernel": np.zeros_like(k), "bias": full(8, 1.0)}}}},
        "batch_stats": {"rpn": {"block0": {"FusedConvBN_0": {"mean": full(8, 0.0),
                                                             "var": full(8, 1.0)}}}},
    }
    weird = {"params": {"rpn": {"block0": {"SomeOldConv_0": {"kernel": k,
                                                             "bias": full(8, 0.0)}}}}}
    tgt2 = {"params": {"rpn": {"block0": {"NewConv_0": {"kernel": np.zeros_like(k),
                                                        "bias": full(8, 0.0)}}}}}
    stage1 = {"params": {"stage1": {"w": full(3, 1.0)}}}
    both = {"params": {"stage1": {"w": full(3, 0.0)}, "stage2": {"w": full(3, 0.0)}}}
    simple_t = {"a": np.zeros((2, 2), np.float32), "b": np.zeros(3, np.float32),
                "c": np.zeros(1, np.float32)}
    simple_r = {"a": np.ones((2, 2), np.float32), "b": np.ones(4, np.float32)}
    return dict(legacy=(legacy, target), rename=(weird, tgt2), overlay=(stage1, both),
                simple=(simple_r, simple_t))


class _Warnings(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.mark.parametrize("case", ["legacy", "rename", "overlay", "simple"])
def test_migration_and_tolerant_loading_match_tdal(case):
    """``tests/test_runtime.py``'s cases through both packages: the same migrated
    trees, the same overlays and skip warnings, and the same loud error on a layer
    rename (with ``allow_partial_modules`` the same partial overlay)."""
    restored, target = _legacy_cases()[case]
    if case == "legacy":
        assert_bit_equal(tck.migrate_legacy_conv_params(restored),
                         jck.migrate_legacy_conv_params(restored))
    if case == "rename":
        with pytest.raises(ValueError, match="layer rename") as port_err:
            tck.load_params_tolerant(restored, target)
        with pytest.raises(ValueError, match="layer rename") as tdal_err:
            jck.load_params_tolerant(restored, target)
        assert str(port_err.value) == str(tdal_err.value)
    kw = {"allow_partial_modules": True} if case == "rename" else {}
    logs = {}
    for side, fn in (("port", tck.load_params_tolerant), ("tdal", jck.load_params_tolerant)):
        log = logging.Logger(f"tolerant.{side}")
        log.addHandler(handler := _Warnings())
        out = fn(restored, target, logger=log, **kw)
        logs[side] = (jax.tree_util.tree_map(np.asarray, out), handler.messages)
    assert_bit_equal(logs["port"][0], logs["tdal"][0])
    assert logs["port"][1] == logs["tdal"][1]
    if case == "legacy":
        np.testing.assert_array_equal(
            logs["port"][0]["params"]["rpn"]["block0"]["FusedConvBN_0"]["kernel"],
            restored["params"]["rpn"]["block0"]["Conv_0"]["kernel"])


def test_async_checkpoint_manager(tmp_path):
    """The port's ``CheckpointManager(use_async=True)``: ``save`` returns before the
    file is written from a copy of the state taken at the call, the markers appear at
    ``wait()``, ``restore`` waits, GC keeps the best; a failed write raises at
    ``wait()``."""
    mgr = tck.CheckpointManager(tmp_path / "ck", max_to_keep=1, use_async=True)
    w = torch.arange(8.0)
    mgr.save(1, {"model": {"w": w}}, meta={"acc": 0.5}, is_best=True)
    w += 100  # training goes on: the save holds the values at the call
    assert not (tmp_path / "ck" / "latest.json").exists() or mgr._pending == []
    mgr.wait()
    assert json.loads((tmp_path / "ck" / "latest.json").read_text()) == {"step": 1}
    state, meta = mgr.restore()
    assert torch.equal(state["model"]["w"], torch.arange(8.0)) and meta == {"acc": 0.5, "step": 1}
    mgr.save(2, {"model": {"w": torch.ones(8)}}, meta={"acc": 0.4})
    mgr.save(3, {"model": {"w": torch.zeros(8)}}, meta={"acc": 0.3})
    state, meta = mgr.restore()  # waits for both
    assert meta["step"] == 3 and torch.equal(state["model"]["w"], torch.zeros(8))
    assert sorted(mgr.all_steps()) == [1, 3] and mgr.best_step() == 1
    mgr.save(4, {"model": {"f": lambda: 0}})  # a lambda: torch.save cannot pickle it
    with pytest.raises((AttributeError, pickle.PicklingError)):
        mgr.wait()
    assert mgr.latest_step() == 3


# ---------------------------------------------------------------------------
# the CLIs on tdal's directories
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pp_tiny_dir(tmp_path_factory):
    """A tdal checkpoint directory of pp_tiny (seeded values at tdal's shapes, two
    steps) and a 4-frame synthetic split."""
    root = tmp_path_factory.mktemp("pp_tiny")
    trees = [variables(detector_shapes(PP_TINY, (1, 4096, 5)), seed=s) for s in (1, 2)]
    for tree in trees:  # a zero final heatmap bias: scores away from the threshold
        sep = tree["params"]["CenterHead_0"]["SepHead_0"]
        sep["final_conv_bias"][...] = 0.0
    mgr = jck.CheckpointManager(root / "ckpt")
    mgr.save(3, trees[0], meta={"epoch": 1})
    mgr.save(6, trees[1], meta={"epoch": 2})
    jmake_synthetic_dataset(root / "data", n_scenes=1, n_frames=4, seed=3, n_static=2,
                            n_dynamic=1, points_per_object=64, n_background=256)
    return root, trees[1]


def test_dist_test_on_a_tdal_directory_matches_tools(pp_tiny_dir, tmp_path):
    """``dist_test --checkpoint <tdal's directory>`` (its latest step) against
    ``tools/dist_test.py`` on the same directory: the same frames, the same kept boxes,
    boxes and scores within DET_TOL."""
    root, _ = pp_tiny_dir
    args = [ROOT / PP_TINY, "--checkpoint", root / "ckpt", "--info_path",
            root / "data" / "infos.pkl", "--batch_size", 2]
    _run_tdal("dist_test.py", [*args, "--work_dir", tmp_path / "tdal"])
    _run_port("dist_test", [*args, "--work_dir", tmp_path / "port", *CPU])
    want = load_pickle(tmp_path / "tdal" / "prediction.pkl")
    got = load_pickle(tmp_path / "port" / "prediction.pkl")
    assert list(got) == list(want)
    for token in want:
        for k in ("box3d_lidar", "scores", "label_preds"):
            g, w = np.asarray(got[token][k]), np.asarray(want[token][k])
            assert g.shape == w.shape and len(w), (token, k)
            np.testing.assert_allclose(g, w, rtol=0, atol=DET_TOL * max(1, np.abs(w).max()),
                                       err_msg=f"{token} {k}")
    assert "restored tdal checkpoint" in (tmp_path / "port" / "test.log").read_text()


def test_train_resumes_from_a_tdal_directory(pp_tiny_dir, tmp_path):
    """``train --resume_from <tdal's directory>``: tdal's resume (the latest step's
    weights and step, a fresh optimizer), then an epoch of 2 steps: the checkpoint of
    step 6 + 2."""
    root, tree = pp_tiny_dir
    work = tmp_path / "resume"
    _run_port("train", [ROOT / PP_TINY, "--work_dir", work, "--info_path",
                        root / "data" / "infos.pkl", "--total_epochs", 1, "--batch_size", 2,
                        "--no_val", "--resume_from", root / "ckpt", *CPU])
    log = (work / "train.log").read_text()
    assert "resumed from" in log and "'step': 6" in log
    assert [p.name for p in (work / "checkpoints").glob("step_*.pt")] == ["step_00000008.pt"]


@pytest.fixture(scope="module")
def labeler_dirs(tmp_path_factory):
    """tdal checkpoint directories of the one-box static and the dynamic labelers
    (flax's init with BatchNorm statistics drawn from a seed; step 1 best, step 2
    latest) and a synthetic segment's static and dynamic tracks."""
    root = tmp_path_factory.mktemp("labelers")
    scene = JScene(0, n_frames=4, seed=3, n_static=2, n_dynamic=2, points_per_object=64,
                   n_background=256)
    infos = scene.write(root / "data")
    dump_pickle(infos, root / "data" / "infos.pkl")
    for kind, only in (("static", "static"), ("dynamic", "dynamic")):
        track = {f"{tid}": t for tid, t in scene.make_track_data(only=only).items()}
        dump_pickle(track, root / f"track_{kind}.pkl")
    trees = {}
    for kind, model_type in (("static", "one_box_est"), ("dynamic", "dynamic")):
        model = jmake_labeler(model_type, 64)[0]
        shapes = [(2, 320, 4), (2, 101, 8), (2, 7)] if kind == "dynamic" else \
            [(2, 256, 3), (2, 7), (2, 7)]
        inputs = [np.zeros(s, np.float32) for s in shapes]
        best, latest = ({"params": p, "batch_stats": b} for p, b in
                        (flax_variables(model, *inputs, seed=s) for s in (11, 12)))
        mgr = jck.CheckpointManager(root / kind)
        mgr.save(1, best, meta={"epoch": 1, "eval_iou3d_acc": 0.5}, is_best=True)
        mgr.save(2, latest, meta={"epoch": 2, "eval_iou3d_acc": 0.25})
        trees[kind] = best
    return root, trees


# the labelers' metrics at fresh-init weights: the corner IoU of their far-off boxes
# reaches 1e7-1e8 (tdal's arithmetic, kept by the port), where f32 rounding in another
# summation order reads about 4e-6 relative
_NUMBER = re.compile(r"-?\d+\.\d+")
LOG_RTOL = 1e-4


def _messages(log_file):
    return [line.split("  ", 2)[2] for line in Path(log_file).read_text().splitlines()]


@pytest.mark.parametrize("kind", ["static", "dynamic"])
def test_labeler_eval_on_a_tdal_directory_matches_tools(labeler_dirs, tmp_path, kind):
    """``static_eval`` / ``dynamic_eval --model_path <tdal's directory>`` against
    ``tools/`` on the same directory: the best step's weights (the same state dict as
    from tdal's tree) and the same log lines, their numbers within LOG_RTOL."""
    root, trees = labeler_dirs
    model_type = "one_box_est" if kind == "static" else "dynamic"
    model = make_labeler(model_type, 64, device="cpu")[0]
    model, meta = restore_labeler_state(model, root / kind)
    assert meta == {"epoch": 1, "eval_iou3d_acc": 0.5, "step": 1}
    assert_same_state(dict(model.state_dict()), flax_to_state_dict(
        model, trees[kind]["params"], trees[kind]["batch_stats"]))
    args = ["--track", root / f"track_{kind}.pkl", "--infos", root / "data" / "infos.pkl",
            "--model_path", root / kind, "--batch_size", 2, "--n_object_points", 64,
            "--npoints", 256 if kind == "static" else 64]
    if kind == "static":
        args += ["--model_type", model_type]
    logs = {}
    for side, run, extra in (("tdal", _run_tdal, []), ("port", _run_port, CPU)):
        _run = f"{kind}_eval" + (".py" if side == "tdal" else "")
        run(_run, [*args, "--work_dir", tmp_path / side, *extra])
        log_file = next((tmp_path / side / "log").rglob("*.txt"))
        logs[side] = [m.replace(str(tmp_path / side), "W") for m in _messages(log_file)]
    assert len(logs["port"]) == len(logs["tdal"])
    for got, want in zip(logs["port"], logs["tdal"]):
        assert _NUMBER.sub("#", got) == _NUMBER.sub("#", want)
        np.testing.assert_allclose([float(x) for x in _NUMBER.findall(got)],
                                   [float(x) for x in _NUMBER.findall(want)],
                                   rtol=LOG_RTOL, err_msg=want)
    assert any("Loaded checkpoint meta" in m for m in logs["port"])


def test_first_stage_pretrained_and_two_stage_dist_test_from_tdal(pp_tiny_dir, tmp_path):
    """``first_stage_cfg.pretrained`` naming tdal's detector directory loads its latest
    step into the first stage; ``dist_test`` takes a two-stage checkpoint of tdal's."""
    root = pp_tiny_dir[0]
    cfg = Config.fromfile(str(ROOT / TWO_STAGE_TINY))
    vox = build_voxel_config(cfg.voxel_generator, train=True)
    first = build_detector(cfg.model["first_stage_cfg"], vox, device="cpu")
    engine = build_two_stage_engine(cfg.model, vox, build_test_cfg(cfg.test_cfg, first, vox),
                                    device="cpu")
    jcfg = JConfig.fromfile(str(ROOT / TWO_STAGE_TINY))
    jfirst = jbuild_detector(jcfg.model["first_stage_cfg"],
                             jbuild_voxel_config(jcfg.voxel_generator, train=False))
    tree = variables(jax.eval_shape(lambda p: jfirst.init({"params": jax.random.PRNGKey(0)}, p),
                                    jax.ShapeDtypeStruct((1, 1000, 5), jnp.float32)), seed=9)
    save_tdal(tmp_path / "first", tree, step=5)
    model_cfg = dict(cfg.model, first_stage_cfg=dict(cfg.model["first_stage_cfg"],
                                                     pretrained=str(tmp_path / "first")))
    assert load_pretrained_first(engine, types.SimpleNamespace(model=model_cfg),
                                 logging.getLogger("pretrained"))
    assert_same_state({k: v for k, v in engine.first.state_dict().items()},
                      pointpillars_state_dict(engine.first, tree["params"], tree["batch_stats"]))

    shapes, engine, convert = _two_stage_case()
    two = variables(shapes, seed=8)
    save_tdal(tmp_path / "two", two, step=4)
    _run_port("dist_test", [ROOT / TWO_STAGE_TINY, "--checkpoint", tmp_path / "two",
                            "--info_path", root / "data" / "infos.pkl", "--batch_size", 2,
                            "--work_dir", tmp_path / "test", *CPU])
    pred = load_pickle(tmp_path / "test" / "prediction.pkl")
    assert len(pred) == 4
    load_tdal_checkpoint(engine, tmp_path / "two")
    assert_same_state({k: v.clone() for k, v in engine.state_dict().items()},
                      {k: v.clone() for k, v in convert(engine, two).items()})


# ---------------------------------------------------------------------------
# the committed fixture (chip_smoke.py phase 13)
# ---------------------------------------------------------------------------


def test_committed_fixture_is_tdals_and_fits():
    """``tests/data/tdal_ckpt`` holds what ``make_fixture.py`` says: tdal's own restore
    of its directories equals ``expected.npz``, the legacy layout migrates to step 2,
    the whole fixture is at most 256 KB, and tdal's and the port's synthetic generators
    make the same two frames from ``fixture_frames``."""
    expected = dict(np.load(FIXTURE / "expected.npz"))
    total = sum(p.stat().st_size for p in FIXTURE.rglob("*") if p.is_file())
    assert total <= 256 * 1024
    mgr = jck.CheckpointManager(FIXTURE / "ckpt")
    assert (mgr.latest_step(), mgr.best_step()) == (2, 1)
    for step in (1, 2):
        tree = mgr.restore(step)[0]
        flat = {"/".join(k): np.asarray(v) for k, v in _flat(tree).items()}
        assert flat.keys() == {k[6:] for k in expected if k.startswith(f"step{step}/")}
        for k, v in flat.items():
            assert _leaf_bytes(v) == _leaf_bytes(expected[f"step{step}/{k}"]), k
    legacy = jck.migrate_legacy_conv_params(jck.CheckpointManager(FIXTURE / "legacy")
                                            .restore()[0])
    assert {"/".join(k): np.asarray(v) for k, v in _flat(legacy).items()}.keys() == \
        {k[6:] for k in expected if k.startswith("step2/")}
    cfg = Config.fromfile(str(FIXTURE / "pp_narrow.py"))
    assert JConfig.fromfile(str(FIXTURE / "pp_narrow.py")).model == cfg.model
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        j = jmake_synthetic_dataset(Path(tmp) / "j", **cfg.fixture_frames)[0]
        t = make_synthetic_dataset(Path(tmp) / "t", **cfg.fixture_frames)[0]
        for a, b in zip(j, t):
            for key in ("path", "anno_path"):
                pa, pb = load_pickle(a[key]), load_pickle(b[key])
                if key == "path":
                    np.testing.assert_array_equal(pa["lidars"]["points_xyz"],
                                                  pb["lidars"]["points_xyz"])
                else:
                    assert [o["box"].tolist() for o in pa["objects"]] == \
                        [o["box"].tolist() for o in pb["objects"]]


def test_phase_13_reads_and_serves_the_fixture_on_the_cpu(tmp_path):
    """``chip_smoke.py`` phase 13 with ``device="cpu"``: its reading child (where jax,
    orbax, tensorstore, zstandard, zarr and numcodecs cannot be imported) and its
    serving half (``dist_test`` and the head maps against tdal's recorded ones)."""
    import chip_smoke

    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--tdal-read-child",
                          str(FIXTURE), str(tmp_path)], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    read = json.loads(res.stdout.strip().splitlines()[-1])
    assert read["leaves"] == {"directory, latest step": 34, "directory, best step": 34,
                              "file:// tarball": 34, "file:// tarball, cached": 34,
                              ".npz": 34, "legacy layout, migrated": 34}
    serve = chip_smoke.serve_tdal_checkpoint(torch.device("cpu"), FIXTURE, tmp_path)
    assert serve["differing"] == 0 and serve["frames_compared"] == 2
    assert max(serve["map_rel_err"].values()) <= chip_smoke.MAP_TOL
