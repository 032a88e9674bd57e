"""The port's data preparation against tdal's, exactly: both sides are numpy.

The frames of ``tests/test_data_prep.py``'s ``prep_root`` fixture (2 scenes of 6
frames, seed 11), written once by tdal's ``SyntheticScene`` and once by the port's into
another root, go through each package: ``sort_frame``, ``create_waymo_infos`` (one and
two sweeps), ``create_groundtruth_database`` (its dbinfos and the bytes of every
``.bin``, with tdal's storage subsampling), ``box_collision_test``, ``DBSampler``'s
draws over epochs of ``_BatchSampler``, ``build_db_sampler`` on the Waymo PP config's
block, ``DetectionDataset`` items with the sampler on (a frame cut at ``max_points``
among them), ``noise_per_object`` and ``points_to_bev`` on the inputs of
``tests/test_metrics_and_noise.py``, the dataset wrappers and the registries.
"""

import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from tdal.core import targets as jtargets
from tdal.core.voxel import VoxelConfig as JVoxelConfig
from tdal.data import gt_augment as jaug
from tdal.data import object_noise as jnoise
from tdal.data import waymo_converter as jconv
from tdal.data.detection import DetectionDataset as JDetectionDataset
from tdal.data.detection import collate_detection as jcollate
from tdal_torch.core import targets
from tdal_torch.core.voxel import VoxelConfig
from tdal_torch.data import gt_augment as aug
from tdal_torch.data import object_noise as noise
from tdal_torch.data import waymo_converter as conv
from tdal_torch.data.detection import DetectionDataset, collate_detection
from tdal_torch.data.synthetic import SyntheticScene
from tdal_torch.runtime.config import Config
from test_data_prep import prep_root  # noqa: F401  (tdal's frames)
from test_torch_cli_chain import assert_same

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PP_CONFIG = ROOT / "configs" / "waymo" / "pp" / "waymo_centerpoint_pp_two_pfn_stride1_3x.py"
ASSIGNER = dict(tasks=[dict(num_class=3, class_names=["VEHICLE", "PEDESTRIAN", "CYCLIST"])],
                out_size_factor=1, max_objs=32)
VOX = ((0.0, -16.0, -2.0, 32.0, 16.0, 4.0), (1.0, 1.0, 6.0), 8, 300)  # holds the objects


@pytest.fixture(scope="module")
def roots(prep_root, tmp_path_factory):  # noqa: F811
    """{"tdal": root, "port": root}: ``prep_root``'s frames, and the same scenes written
    by the port's ``SyntheticScene``."""
    root = tmp_path_factory.mktemp("port_prep")
    for i in range(2):
        SyntheticScene(i, n_frames=6, seed=11, n_static=2, n_dynamic=1, points_per_object=64,
                       n_background=256).write(root, split="train")
    return {"tdal": prep_root[0], "port": root}


def _rooted(value, root):
    """``value`` with every string under ``root`` made relative to it."""
    if isinstance(value, dict):
        return {k: _rooted(v, root) for k, v in value.items()}
    if isinstance(value, list):
        return [_rooted(v, root) for v in value]
    if isinstance(value, str) and value.startswith(str(root)):
        return value[len(str(root)):]
    return value


def _infos(roots, nsweeps):
    return {side: mod.create_waymo_infos(roots[side], split="train", nsweeps=nsweeps)
            for side, mod in (("tdal", jconv), ("port", conv))}


def test_the_port_writes_tdals_frames(roots):
    names = sorted(p.relative_to(roots["tdal"]) for p in roots["tdal"].rglob("train/*/*.pkl"))
    assert len(names) == 24
    for name in names:
        assert_same(pickle.loads((roots["port"] / name).read_bytes()),
                    pickle.loads((roots["tdal"] / name).read_bytes()), str(name))


def test_sort_frame_matches_tdal():
    rng = np.random.default_rng(0)
    frames = [f"seq_{s}_frame_{f}.pkl" for s in range(3) for f in (0, 2, 10, 11, 100)]
    frames = [frames[i] for i in rng.permutation(len(frames))]
    assert conv.sort_frame(frames) == jconv.sort_frame(frames)
    assert conv.sort_frame(frames)[:3] == ["seq_0_frame_0.pkl", "seq_0_frame_2.pkl",
                                           "seq_0_frame_10.pkl"]


@pytest.mark.parametrize("nsweeps", [1, 2])
def test_create_waymo_infos_matches_tdal(roots, nsweeps):
    infos = _infos(roots, nsweeps)
    name = f"infos_train_{nsweeps:02d}sweeps_filter_zero_gt.pkl"
    for side in ("tdal", "port"):  # the file holds what the call returned
        assert_same(pickle.loads((roots[side] / name).read_bytes()), infos[side], side)
    assert len(infos["port"]) == 12
    assert_same(_rooted(infos["port"], roots["port"]), _rooted(infos["tdal"], roots["tdal"]))
    if nsweeps == 2:  # frame 0's self-sweep; later frames chain the poses
        assert infos["port"][0]["sweeps"][0]["transform_matrix"] is None
        np.testing.assert_allclose(infos["port"][3]["sweeps"][0]["transform_matrix"][0, 3],
                                   -0.5, atol=1e-6)


def test_create_groundtruth_database_matches_tdal(roots, tmp_path):
    """Same dbinfos and the same bytes in every .bin, with tdal's storage subsampling
    (VEHICLE boxes from every 4th frame, PEDESTRIAN boxes from every 2nd); half the
    boxes are relabelled PEDESTRIAN to reach the second rule."""
    infos = _infos(roots, 1)
    db = {}
    for side, mod in (("tdal", jaug), ("port", aug)):
        for info in infos[side]:
            info["gt_names"] = info["gt_names"].astype("<U10")
            info["gt_names"][::2] = "PEDESTRIAN"
        out = tmp_path / side
        db[side] = mod.create_groundtruth_database(infos[side], out, nsweeps=1)
        assert_same(pickle.loads((out / "dbinfos_train_1sweeps_withvelo.pkl").read_bytes()),
                    db[side])
    assert_same(db["port"], db["tdal"])
    assert {k: len(v) for k, v in db["port"].items()} == {"PEDESTRIAN": 12, "VEHICLE": 3}
    assert {i["image_idx"] % 4 for i in db["port"]["VEHICLE"]} == {0}
    assert {i["image_idx"] % 2 for i in db["port"]["PEDESTRIAN"]} == {0}
    bins = sorted(p.relative_to(tmp_path / "port")
                  for p in (tmp_path / "port").rglob("*.bin"))
    assert len(bins) == 15
    for name in bins:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "tdal" / name).read_bytes()


def _boxes(rng, n, spread=8.0):
    b = np.zeros((n, 9))
    b[:, :2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 3:5] = rng.uniform(0.5, 5.0, (n, 2))
    b[:, 8] = rng.uniform(-np.pi, np.pi, n)
    return b


def test_box_collision_test_matches_tdal():
    rng = np.random.default_rng(3)
    a, b = _boxes(rng, 40), _boxes(rng, 30)
    got = aug.box_collision_test(a, b)
    np.testing.assert_array_equal(got, jaug.box_collision_test(a, b))
    assert 0 < got.sum() < got.size
    # edge contact counts as a collision (the 1e-9 margin); a clear gap does not
    pair = np.array([[0, 0, 0, 2, 4, 1, 0, 0, 0.0], [2, 0, 0, 2, 4, 1, 0, 0, 0.0],
                     [2 + 5e-10, 0, 0, 2, 4, 1, 0, 0, 0.0], [2 + 1e-6, 0, 0, 2, 4, 1, 0, 0, 0.0]])
    for mod in (aug, jaug):
        assert mod.box_collision_test(pair[:1], pair[1:]).tolist() == [[True, True, False]]
    assert aug.box_collision_test(a[:0], b).shape == (0, 30)


@pytest.fixture(scope="module")
def dbinfos(roots):
    """The port's database (no subsampling: 36 crops) and its root."""
    infos = conv.create_waymo_infos(roots["port"], split="train", nsweeps=1)
    return aug.create_groundtruth_database(infos, roots["port"], nsweeps=1,
                                           waymo_subsample=False), roots["port"]


def test_db_sampler_draws_match_tdal(dbinfos):
    """A sequence of ``sample_all`` draws over several epochs of ``_BatchSampler``
    (36 crops, deficits up to 10), each frame's boxes to avoid from the previous draw;
    ``rng`` is never read, so a different generator on each side changes nothing."""
    infos, root = dbinfos
    assert len(infos["VEHICLE"]) == 36
    kw = dict(sample_groups={"VEHICLE": 10, "PEDESTRIAN": 4}, min_points={"VEHICLE": 5},
              point_features=5, seed=4)
    got, ref = aug.DBSampler(infos, root, **kw), jaug.DBSampler(infos, root, **kw)
    assert got.sample_groups == ref.sample_groups == {"VEHICLE": 10}
    rng = np.random.default_rng(9)
    frame = np.zeros((0, 9), np.float32)
    n_out = 0
    for step in range(12):
        names = np.array(["VEHICLE"] * len(frame))
        out = got.sample_all(frame, names, None if step % 2 else np.random.default_rng(step))
        want = ref.sample_all(frame, names, rng)
        assert_same(out, want, f"draw {step}")
        if out is not None:
            n_out += len(out["gt_boxes"])
            frame = out["gt_boxes"][: step % 4]
    assert n_out > 36  # the draws went past one epoch of the list


def test_build_db_sampler_matches_tdal_on_the_waymo_pp_block(dbinfos, tmp_path):
    infos, root = dbinfos
    block = dict(Config.fromfile(PP_CONFIG).train_preprocessor["db_sampler"])
    assert block["enable"] is False
    path = tmp_path / "dbinfos_train_1sweeps_withvelo.pkl"
    path.write_bytes(pickle.dumps(infos))
    cases = {"disabled": block, "missing": dict(block, enable=True),
             "enabled": dict(block, enable=True, db_info_path=str(path))}
    for case, cfg_db in cases.items():
        got = aug.build_db_sampler(cfg_db, point_features=5)
        ref = jaug.build_db_sampler(cfg_db, point_features=5)
        if case != "enabled":
            assert got is None and ref is None, case
            continue
        assert got.sample_groups == ref.sample_groups == {"VEHICLE": 15}
        assert (got.rate, got.point_features, got.root_path) == \
            (ref.rate, ref.point_features, ref.root_path) == (1.0, 5, tmp_path)
        assert_same(got._infos["VEHICLE"]._list, ref._infos["VEHICLE"]._list)
        np.testing.assert_array_equal(got._infos["VEHICLE"]._idx, ref._infos["VEHICLE"]._idx)


def test_detection_dataset_with_the_sampler_matches_tdal(roots, dbinfos):
    """Items with GT-aug, element for element, over two epochs of the frames; with
    ``max_points`` below a frame's points, so the cut after the paste applies."""
    infos, root = dbinfos
    frames = conv.create_waymo_infos(roots["port"], split="train", nsweeps=1)
    kw = dict(class_names=["VEHICLE", "PEDESTRIAN", "CYCLIST"], mode="train", max_points=560,
              seed=0)
    sampler = dict(sample_groups={"VEHICLE": 8}, min_points={"VEHICLE": 5}, seed=1)
    ref = JDetectionDataset(frames, assigner=jtargets.AssignerConfig(**ASSIGNER),
                            voxel_cfg=JVoxelConfig(*VOX),
                            db_sampler=jaug.DBSampler(infos, root, **sampler), **kw)
    got = DetectionDataset(frames, assigner=targets.AssignerConfig(**ASSIGNER),
                           voxel_cfg=VoxelConfig(*VOX),
                           db_sampler=aug.DBSampler(infos, root, **sampler), **kw)
    order = list(range(len(frames))) * 2
    items_ref = [ref[i] for i in order]
    items_got = [got[i] for i in order]
    for g, r in zip(items_got, items_ref):
        assert_same(g, r, g["token"])
    boxes = [int(sum(m.sum() for m in it["mask"])) for it in items_got]
    assert max(boxes) > 3  # the frames hold 3 objects: more are pasted
    cut = [np.isfinite(it["points"][:, 0]).all() for it in items_got]
    assert any(cut) and not all(cut)  # some frames filled max_points, others were padded
    b_got, b_ref = collate_detection(items_got[:4]), jcollate(items_ref[:4])
    assert_same(b_got, b_ref)


def test_noise_per_object_and_points_to_bev_match_tdal():
    boxes = np.array([[0, 0, 0, 1.8, 4.8, 1.5, 0, 0, 0.0], [30, 30, 0, 1.8, 4.8, 1.5, 0, 0, 0.0],
                      [2.0, 1.0, 0, 1.8, 4.8, 1.5, 0, 0, 0.4]])
    pts = np.array([[0.5, 0.5, 0.0], [30.2, 30.1, 0.0], [100.0, 100.0, 0.0], [2.2, 1.3, 0.1]])
    for kw in (dict(center_noise_std=0.5), dict(rotation_perturb=[-0.3, 0.6], num_try=2)):
        got = noise.noise_per_object(boxes.copy(), pts.copy(), np.random.default_rng(0), **kw)
        want = jnoise.noise_per_object(boxes.copy(), pts.copy(), np.random.default_rng(0), **kw)
        assert_same(got, want)
        assert np.abs(got[0] - boxes).max() > 0
    assert_same(noise.noise_per_object(boxes.copy()), jnoise.noise_per_object(boxes.copy()))
    rng = np.random.default_rng(1)
    cloud = np.concatenate([rng.uniform(-3, 3, (200, 3)), [[0.5, 0.5, 1.0], [-100, 0, 0]]])
    for with_height in (True, False):
        assert_same(noise.points_to_bev(cloud, [-2, -2, -1, 2, 2, 3], [0.5, 0.5], with_height),
                    jnoise.points_to_bev(cloud, [-2, -2, -1, 2, 2, 3], [0.5, 0.5], with_height))


def test_dataset_wrappers_and_registries_match_tdal():
    import tdal.models  # noqa: F401  (fills tdal's registries)
    import tdal_torch.models  # noqa: F401
    from tdal.data import dataset_wrappers as jwrap
    from tdal.runtime import registry as jreg
    from tdal_torch.data import dataset_wrappers as wrap
    from tdal_torch.models.static_labeler import StaticLabelerOneBox
    from tdal_torch.runtime import registry as reg

    class Toy:
        class_names = ["VEHICLE"]

        def __init__(self, items):
            self.items = items

        def __len__(self):
            return len(self.items)

        def __getitem__(self, i):
            return self.items[i]

    for mod in (wrap, jwrap):
        cat = mod.ConcatDataset([Toy([1, 2, 3]), Toy([10, 20])])
        assert [cat[i] for i in range(-1, 5)] == [20, 1, 2, 3, 10, 20]
        with pytest.raises(IndexError):
            cat[5]
        rep = mod.RepeatDataset(Toy([1, 2, 3]), times=3)
        assert [rep[i] for i in range(len(rep))] == [1, 2, 3] * 3
        assert cat.class_names == rep.class_names == ["VEHICLE"]
    assert reg.DATASETS.get("ConcatDataset") is wrap.ConcatDataset
    assert reg.DATASETS.get("RepeatDataset") is wrap.RepeatDataset
    for name in ("READERS", "BACKBONES", "NECKS", "HEADS", "DETECTORS", "SECOND_STAGE",
                 "ROI_HEAD", "LABELERS", "DATASETS"):
        assert sorted(getattr(reg, name).module_dict) == sorted(getattr(jreg, name).module_dict)
    cfg = {"type": "one_box_est", "n_object_points": 64}
    model = reg.build_from_cfg(cfg, reg.LABELERS)
    assert isinstance(model, StaticLabelerOneBox)
    assert model.n_object_points == jreg.build_from_cfg(cfg, jreg.LABELERS).n_object_points == 64
    with pytest.raises(KeyError):
        reg.build_from_cfg({"type": "nothing"}, reg.LABELERS)
