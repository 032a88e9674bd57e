"""tdal_torch labeler eval forwards and the object-point gather against tdal (CPU).

Full layer widths, small point counts (static N=256, dynamic 5x64). Tolerance
TOL: f32 on both sides, XLA vs torch summation order; measured <= 4e-6 on these
outputs (size residuals reach ~10). The seg masks are compared exactly, and every
seg logit margin and argmax gap of the inputs exceeds 100x TOL, so a flipped mask
or bin cannot hide behind the tolerance.
"""

import jax
import numpy as np
import pytest
import torch

from tdal.models.dynamic_labeler import DynamicLabeler as FlaxDynamic
from tdal.models.pointnet import gather_object_points as flax_gather
from tdal.models.static_labeler import StaticLabelerOneBox as FlaxOneBox
from tdal.models.static_labeler import StaticLabelerTwoBox as FlaxTwoBox
from tdal_torch.convert import load_flax
from tdal_torch.models.dynamic_labeler import DynamicLabeler
from tdal_torch.models.pointnet import gather_object_points
from tdal_torch.models.static_labeler import StaticLabelerOneBox, StaticLabelerTwoBox
from test_torch_fused_pointnet import flax_variables

torch.set_num_threads(2)

TOL = 1e-5


def _gather_case(seed, b=4, n=64):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(b, n, 4)).astype(np.float32)
    logits = rng.normal(size=(b, n, 2)).astype(np.float32)
    logits[1, :, 1] = logits[1, :, 0] - 1.0  # no positive point: zero rows
    logits[2, :, 1] = logits[2, :, 0] + 1.0  # every point positive: all keys tie
    logits[3, : n // 2, 1] = logits[3, : n // 2, 0] + 1.0  # n/2 positives
    return pts, logits


@pytest.mark.parametrize("n_pts", [16, 100])  # fewer / more slots than points
@pytest.mark.parametrize("with_noise", [False, True])
def test_gather_object_points_identical(n_pts, with_noise):
    pts, logits = _gather_case(0)
    key = jax.random.PRNGKey(3) if with_noise else None
    ref_pts, ref_mask = flax_gather(pts, logits, n_pts, key)
    noise = (
        torch.from_numpy(np.array(jax.random.uniform(key, logits.shape[:2])))
        if with_noise else None
    )
    got_pts, got_mask = gather_object_points(
        torch.from_numpy(pts), torch.from_numpy(logits), n_pts, noise
    )
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_array_equal(got_pts.numpy(), np.asarray(ref_pts))


def _inputs(kind, rng, b=2):
    if kind == "dynamic":
        return (
            rng.normal(size=(b, 5 * 64, 4)).astype(np.float32),
            rng.normal(size=(b, 101, 8)).astype(np.float32),
            rng.normal(size=(b, 7)).astype(np.float32),
        )
    init_box = np.concatenate(
        [rng.normal(size=(b, 3)), rng.uniform(1, 5, (b, 3)), rng.uniform(-3, 3, (b, 1))], 1
    ).astype(np.float32)
    return (rng.normal(size=(b, 256, 3)).astype(np.float32), init_box, init_box + 0.1)


# seeds chosen so that each seg mask is mixed (fresh-init masks are often all one
# class) and every decision sits more than 100x TOL from its boundary
CASES = {
    "one_box": (FlaxOneBox, StaticLabelerOneBox, 9),
    "two_box": (FlaxTwoBox, StaticLabelerTwoBox, 17),
    "dynamic": (FlaxDynamic, DynamicLabeler, 6),
}


def margins(out) -> dict:
    """Distance of every discrete decision from its boundary: the seg logit margin
    and the top-1/top-2 gap of each argmax the decode takes."""
    lg = np.asarray(out["logits"])
    m = {"seg": float(np.abs(lg[..., 1] - lg[..., 0]).min())}
    for k in ("heading_scores", "size_scores", "heading_scores_one", "size_scores_one"):
        if k in out:
            top = np.sort(np.asarray(out[k]), axis=1)
            m[k] = float((top[:, -1] - top[:, -2]).min())
    return m


@pytest.mark.parametrize("kind", sorted(CASES))
def test_labeler_forward_matches_flax(kind):
    flax_cls, torch_cls, seed = CASES[kind]
    args = _inputs(kind, np.random.default_rng(seed))
    params, bs = flax_variables(flax_cls(), *args, seed=seed)
    ref = flax_cls().apply({"params": params, "batch_stats": bs}, *args, train=False)
    assert min(margins(ref).values()) > 100 * TOL, margins(ref)
    model = load_flax(torch_cls(), params, bs).eval()
    with torch.inference_mode():
        out = model(*(torch.from_numpy(a) for a in args))
    assert set(out) == set(ref)
    np.testing.assert_array_equal(out["mask"].numpy(), np.asarray(ref["mask"]))
    assert 0 < int(out["mask"].sum()) < out["mask"].numel()  # a mixed mask
    for k, v in ref.items():
        if k == "mask":
            continue
        got = out[k].numpy()
        if np.issubdtype(np.asarray(v).dtype, np.integer):
            np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)
        else:
            np.testing.assert_allclose(got, np.asarray(v), rtol=TOL, atol=TOL, err_msg=k)


def test_labelers_refuse_train_mode():
    """Training needs its random draws (gather noise, dropout mask) as inputs: a
    train-mode forward without them is refused, not drawn behind the caller's back."""
    model = StaticLabelerOneBox()
    with pytest.raises(ValueError, match="keep-mask"):
        model(torch.zeros(1, 8, 3), torch.zeros(1, 7))
    with pytest.raises(ValueError, match="gather noise"):
        model(torch.zeros(1, 8, 3), torch.zeros(1, 7), keep=torch.ones(1, 8, 128, dtype=torch.bool))


def test_codecs_match_tdal():
    """Heading-bin and size-cluster codecs, exactly (same f32 arithmetic) apart
    from the residuals, within f32 rounding."""
    from tdal.core import codecs as jc
    from tdal_torch.core import codecs as tc

    rng = np.random.default_rng(5)
    angle = rng.uniform(-10, 10, 64).astype(np.float32)
    angle[:3] = [0.0, np.pi, -np.pi / 12]  # bin edges
    lwh = rng.uniform(0.5, 11, (64, 3)).astype(np.float32)

    cls, res = tc.angle2class(torch.from_numpy(angle))
    j_cls, j_res = jc.angle2class(angle)
    np.testing.assert_array_equal(cls.numpy(), np.asarray(j_cls))
    np.testing.assert_allclose(res.numpy(), np.asarray(j_res), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        tc.class2angle(cls, res).numpy(), np.asarray(jc.class2angle(j_cls, j_res)),
        rtol=0, atol=1e-6,
    )
    s_cls, s_res = tc.size2class(torch.from_numpy(lwh))
    j_scls, j_sres = jc.size2class(lwh)
    np.testing.assert_array_equal(s_cls.numpy(), np.asarray(j_scls))
    np.testing.assert_allclose(s_res.numpy(), np.asarray(j_sres), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        tc.class2size(s_cls, s_res).numpy(), np.asarray(jc.class2size(j_scls, j_sres)),
        rtol=0, atol=1e-6,
    )
