"""The port's visualisation (``tdal_torch.utils.visualize`` and
``python -m tdal_torch.tools.visualize.vis_{data,track,pred}``) against tdal's
(``tdal/utils/visualize.py``, ``tools/visualize/``): the polylines each figure draws
(their coordinates and colours) and the files each CLI writes, not PNG bytes; the open3d
viewers' gate raises the same ``ImportError`` where open3d is missing."""

import importlib.util

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from matplotlib.figure import Figure  # noqa: E402

from tdal.data.synthetic import SyntheticScene, make_synthetic_dataset  # noqa: E402
from tdal.data.waymo_schema import dump_pickle  # noqa: E402
from tdal.utils import visualize as J  # noqa: E402
from tdal_torch.utils import visualize as T  # noqa: E402
from test_torch_cli_chain import _run_port, _run_tdal  # noqa: E402

torch.set_num_threads(2)

HAS_OPEN3D = importlib.util.find_spec("open3d") is not None


def _drawn(fig) -> list:
    """Each line of the figure's axes: (xy points, colour), and the axes' limits."""
    ax = fig.axes[0]
    lines = [(np.asarray(line.get_xydata()), matplotlib.colors.to_rgba(line.get_color()))
             for line in ax.get_lines()]
    return lines, ax.get_xlim(), ax.get_ylim(), ax.get_title()


def assert_same_drawing(a, b):
    la, *rest_a = a
    lb, *rest_b = b
    assert len(la) == len(lb) and rest_a == rest_b
    for (xa, ca), (xb, cb) in zip(la, lb):
        np.testing.assert_array_equal(xa, xb)
        assert ca == cb


def _boxes(rng, n):
    return np.concatenate([rng.uniform(-30, 30, (n, 2)), rng.uniform(-1, 1, (n, 1)),
                           rng.uniform(1, 5, (n, 3)), rng.uniform(-3, 3, (n, 1))], 1)


def test_plot_bev_plot_track_and_corners_match_tdal():
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(0)
    pts = rng.normal(0, 20, (500, 4))
    boxes, gt = _boxes(rng, 6), _boxes(rng, 3)
    labels = [0, 1, 2, 4, 3, 1]
    figs = [mod.plot_bev(points=pts, boxes=boxes, labels=labels, gt_boxes=gt, title="f")
            for mod in (T, J)]
    assert_same_drawing(_drawn(figs[0]), _drawn(figs[1]))
    assert len(_drawn(figs[0])[0]) == 9
    track = SyntheticScene(0, n_frames=5, seed=4, n_static=1, n_dynamic=1,
                           points_per_object=32).make_track_data()
    for tr in track.values():
        figs += [mod.plot_track(tr, None, title="t") for mod in (T, J)]
        assert_same_drawing(_drawn(figs[-2]), _drawn(figs[-1]))
    for b in boxes:
        np.testing.assert_array_equal(T.box_corners_3d(b), J.box_corners_3d(b))
    for fig in figs:
        plt.close(fig)


@pytest.mark.skipif(HAS_OPEN3D, reason="checks the gate where open3d is missing")
def test_open3d_viewers_raise_tdals_import_error():
    messages = []
    for mod in (T, J):
        for call in (lambda: mod.show_open3d(np.zeros((3, 3))),
                     lambda: mod.show_track_open3d({"point": [], "bbox": []}),
                     lambda: mod.show_sequence_open3d([])):
            with pytest.raises(ImportError) as err:
                call()
            messages.append(str(err.value))
    assert len(set(messages)) == 1 and "plot_bev" in messages[0]


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """Three synthetic frames, per-frame detections (scores on both sides of the
    threshold) in two prediction files, and the scene's tracks."""
    root = tmp_path_factory.mktemp("vis")
    infos, scenes = make_synthetic_dataset(root / "data", n_scenes=1, n_frames=3, seed=6,
                                           n_static=2, n_dynamic=1, points_per_object=32,
                                           n_background=300)
    rng = np.random.default_rng(1)
    for name in ("prediction.pkl", "prediction2.pkl"):
        dump_pickle({info["token"]: {
            "box3d_lidar": np.concatenate([_boxes(rng, 5), rng.normal(0, 1, (5, 2))], 1)
            [:, [0, 1, 2, 3, 4, 5, 7, 8, 6]].astype(np.float32),
            "scores": rng.uniform(0, 1, 5).astype(np.float32),
            "label_preds": rng.integers(0, 3, 5)} for info in infos}, root / name)
    dump_pickle(scenes[0].make_track_data(), root / "track.pkl")
    return root


@pytest.mark.parametrize("tool", ["vis_data", "vis_track", "vis_pred"])
def test_visualize_clis_match_tools(frames, tmp_path, monkeypatch, tool):
    """Each CLI on the same inputs through both packages: the same output files, and
    in each the same polylines."""
    drawn = {}
    savefig = Figure.savefig

    def record(fig, path, *args, **kwargs):
        drawn[str(path)] = _drawn(fig)
        return savefig(fig, path, *args, **kwargs)

    monkeypatch.setattr(Figure, "savefig", record)
    args = {"vis_data": ["--infos", frames / "data" / "infos.pkl", "--n_frames", 2],
            "vis_track": ["--track", frames / "track.pkl", "--n_tracks", 2],
            "vis_pred": ["--prediction", frames / "prediction.pkl", "--prediction2",
                         frames / "prediction2.pkl", "--infos", frames / "data" / "infos.pkl",
                         "--n_frames", 3, "--score_thresh", 0.4]}[tool]
    outputs = {}
    for side in ("tdal", "port"):
        out = tmp_path / side
        if side == "tdal":
            _run_tdal(f"visualize/{tool}.py", [*args, "--out_dir", out])
        else:
            _run_port(f"visualize.{tool}", [*args, "--out_dir", out])
        outputs[side] = sorted(p.name for p in out.iterdir())
    assert outputs["port"] == outputs["tdal"]
    assert len(outputs["port"]) == {"vis_data": 2, "vis_track": 2, "vis_pred": 3}[tool]
    for name in outputs["port"]:
        assert_same_drawing(drawn[str(tmp_path / "port" / name)],
                            drawn[str(tmp_path / "tdal" / name)])
    if tool == "vis_pred" and not HAS_OPEN3D:
        for side, run in (("tdal", _run_tdal), ("port", _run_port)):
            with pytest.raises(ImportError, match="open3d"):
                run("visualize/vis_pred.py" if side == "tdal" else "visualize.vis_pred",
                    [*args, "--open3d", "--sequence"])
