"""tdal_torch labeler training against tdal (CPU, f32): the corner IoU of the metrics,
the frustum losses, the train forwards, one train step and the labelers' schedule.

Full layer widths, small point counts (static N=256 with 64 object points, dynamic
5x64 with 128), batch 4. Both sides take the same random draws: the test patches
tdal's gather noise (``jax.random.uniform`` as ``tdal.models.pointnet`` sees it) and
its seg-head dropout (``nn.Dropout`` there) to arrays made with numpy from a seed, and
feeds the same arrays to the port.

Tolerances:
- LOSS_TOL 1e-6 relative: the losses of the same outputs and labels, the same
  arithmetic (measured 0).
- The train forwards' outputs, loss terms, metrics, gradients and BN running
  statistics: each within GRAD_MARGIN = 8 times a noise floor measured on tdal itself,
  the change of tdal's value when the batch (and its draws) is taken in another order
  (ROADMAP "Contracts carried over"), or TOL = 1e-5 of max(1, |x|) (gradients: of the
  leaf's largest gradient) where that floor reads lower. Batch statistics (over
  B*N rows in train mode, E[x^2] - E[x]^2 as flax takes them, and over the 4 rows of
  the (B, C) stacks) amplify rounding: the outputs differ by up to 8.3e-4 of
  max(1, |x|), at most 0.23 of their tolerance, and the gradients at most 0.26.
- Parameters after the update: 1e-6 (1 + |p|), and, where a gradient is within its
  tolerance of 0, Adam's first step (lr times the sign of the gradient) either way.
"""

import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tdal.models.pointnet as jpn
from tdal.core.iou import compute_box3d_iou as j_compute_box3d_iou
from tdal.models.dynamic_labeler import DynamicLabeler as FlaxDynamic
from tdal.models.static_labeler import StaticLabelerOneBox as FlaxOneBox
from tdal.models.static_labeler import StaticLabelerTwoBox as FlaxTwoBox
from tdal.models.static_labeler import frustum_loss_one_box as j_loss_one
from tdal.models.static_labeler import frustum_loss_two_box as j_loss_two
from tdal.pipeline.labeler_engine import labeler_metrics as j_labeler_metrics
from tdal.pipeline.labeler_engine import make_steps as j_make_steps
from tdal.runtime.schedules import adam_with_schedule as j_adam
from tdal.runtime.schedules import labeler_step_decay as j_step_decay
from tdal.runtime.train_state import TrainState as JTrainState
from tdal_torch.convert import flax_to_state_dict, load_flax
from tdal_torch.core.iou import compute_box3d_iou
from tdal_torch.models.dynamic_labeler import DynamicLabeler
from tdal_torch.models.static_labeler import (
    StaticLabelerOneBox, StaticLabelerTwoBox, frustum_loss_one_box, frustum_loss_two_box,
)
from tdal_torch.pipeline.labeler_engine import labeler_metrics
from tdal_torch.runtime.schedules import adam_with_schedule, labeler_step_decay
from tdal_torch.runtime.train_state import TrainState
from test_torch_fused_pointnet import flax_variables

torch.set_num_threads(2)

LOSS_TOL = 1e-6
TOL = 1e-5
GRAD_MARGIN = 8
B = 4
LR, WEIGHT_DECAY = 1e-3, 1e-4
# (flax class, port class, flax loss, port loss, points, channels, object points, seed)
CASES = {
    "one_box": (FlaxOneBox, StaticLabelerOneBox, j_loss_one, frustum_loss_one_box, 256, 3, 64, 3),
    "two_box": (FlaxTwoBox, StaticLabelerTwoBox, j_loss_two, frustum_loss_two_box, 256, 3, 64, 4),
    "dynamic": (FlaxDynamic, DynamicLabeler, j_loss_one, frustum_loss_one_box, 5 * 64, 4, 128, 5),
}
LABEL_KEYS = ("mask_label", "center_label", "heading_class_label", "heading_residuals_label",
              "size_class_label", "size_residuals_label")
PERMUTATION = [2, 0, 3, 1]


def _boxes(rng, n):
    return np.concatenate(
        [rng.normal(size=(n, 3)), rng.uniform(1, 5, (n, 3)), rng.uniform(-3, 3, (n, 1))], 1
    ).astype(np.float32)


def _batch(kind, seed):
    """Inputs, labels and the train draws (gather noise, dropout keep-mask) of one
    batch, made with numpy from ``seed``."""
    _, _, _, _, n, cin, _, _ = CASES[kind]
    rng = np.random.default_rng(seed)
    batch = {"pts": rng.normal(size=(B, n, cin)).astype(np.float32),
             "init_box": _boxes(rng, B), "bbox_gt": _boxes(rng, B)}
    if kind == "dynamic":
        batch["boxes"] = rng.normal(size=(B, 101, 8)).astype(np.float32)
    batch.update(
        mask_label=(rng.random((B, n)) < 0.5).astype(np.float32),
        center_label=rng.normal(size=(B, 3)).astype(np.float32),
        heading_class_label=rng.integers(0, 12, B).astype(np.int32),
        heading_residuals_label=rng.uniform(-0.25, 0.25, B).astype(np.float32),
        size_class_label=rng.integers(0, 3, B).astype(np.int32),
        size_residuals_label=rng.normal(0, 0.3, (B, 3)).astype(np.float32),
    )
    draws = {"noise": rng.random((B, n), dtype=np.float32),
             "keep": rng.random((B, n, 128)) >= 0.5}
    return batch, draws


def _inputs(kind, batch):
    return (batch["pts"], batch["boxes"] if kind == "dynamic" else batch["init_box"],
            batch["bbox_gt"])


def _permuted(batch, draws):
    return ({k: v[PERMUTATION] for k, v in batch.items()},
            {k: v[PERMUTATION] for k, v in draws.items()})


class _FixedDropout(fnn.Module):
    """flax's ``nn.Dropout`` with the keep-mask ``_DRAWS["keep"]``."""

    rate: float
    deterministic: bool = False

    @fnn.compact
    def __call__(self, x):
        if self.deterministic:
            return x
        return jnp.where(_DRAWS["keep"], x / (1.0 - self.rate), 0.0)


_DRAWS: dict = {}


@pytest.fixture
def tdal_draws(monkeypatch):
    """Makes tdal's labelers take ``_DRAWS``' gather noise and dropout mask: returns a
    setter of the draws. Nothing of tdal changes outside this test's patch."""
    nn_proxy = types.SimpleNamespace(**{k: getattr(fnn, k) for k in dir(fnn)
                                        if not k.startswith("__")})
    nn_proxy.Dropout = _FixedDropout
    jax_proxy = types.SimpleNamespace(
        vmap=jax.vmap, lax=jax.lax,
        random=types.SimpleNamespace(uniform=lambda key, shape: jnp.asarray(_DRAWS["noise"])),
    )
    monkeypatch.setattr(jpn, "nn", nn_proxy)
    monkeypatch.setattr(jpn, "jax", jax_proxy)
    yield _DRAWS.update
    _DRAWS.clear()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


_TDAL_GRADS = {}  # (flax model, loss) -> its jitted gradient function


def _tdal_grads(flax_model, loss_fn, params, bs, batch, draws, set_draws):
    """tdal's train-mode output, loss terms, gradients and new batch stats (the body of
    tdal.pipeline.labeler_engine.make_steps' train step), as numpy. The draws are
    arguments of the jitted function: the patched draws read them while it traces."""
    key = (type(flax_model), flax_model.n_object_points, loss_fn)
    if key not in _TDAL_GRADS:
        rng = jax.random.PRNGKey(0)

        @jax.jit
        def grads_fn(params, bs, inputs, labels, noise, keep):
            set_draws({"noise": noise, "keep": keep})

            def loss_of(p):
                out, mutated = flax_model.apply(
                    {"params": p, "batch_stats": bs}, *inputs, train=True,
                    rngs={"gather": rng, "dropout": rng}, mutable=["batch_stats"])
                losses = loss_fn(out, labels)
                return losses["total_loss"], (losses, out, mutated["batch_stats"])

            grads, (losses, out, new_bs) = jax.grad(loss_of, has_aux=True)(params)
            return out, losses, grads, new_bs

        _TDAL_GRADS[key] = grads_fn
    res = _TDAL_GRADS[key](params, bs, _inputs_of(flax_model, batch),
                           {k: batch[k] for k in LABEL_KEYS}, draws["noise"], draws["keep"])
    return tuple(_np(r) for r in res)


def _inputs_of(flax_model, batch):
    return _inputs("dynamic" if isinstance(flax_model, FlaxDynamic) else "static", batch)


def _port_step(model, loss_fn, batch, draws, kind, optimizer=None):
    """The port's train-mode output, loss terms and gradients (and, with an
    optimizer, the state after its step)."""
    model.train()
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    out = model(*(t(a) for a in _inputs(kind, batch)), noise=t(draws["noise"]),
                keep=t(draws["keep"]))
    labels = {k: t(batch[k]) for k in LABEL_KEYS}
    losses = loss_fn(out, labels)
    model.zero_grad(set_to_none=True)
    losses["total_loss"].backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    if optimizer is not None:
        TrainState(model, optimizer).apply_gradients()
    return out, losses, grads, labels


def _setup(kind):
    flax_cls, torch_cls, j_loss, t_loss, _, _, n_obj, seed = CASES[kind]
    batch, draws = _batch(kind, seed)
    flax_model = flax_cls(n_object_points=n_obj)
    params, bs = flax_variables(flax_model, *_inputs(kind, batch), seed=seed)
    model = load_flax(torch_cls(n_object_points=n_obj), params, bs)
    return flax_model, model, j_loss, t_loss, params, bs, batch, draws


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.maximum(1.0, np.abs(want))
    err = float((np.abs(got - want) / scale).max()) if want.size else 0.0
    assert err <= tol, f"{what}: {err:.3e} > {tol}"
    return err


def test_compute_box3d_iou_matches_tdal():
    rng = np.random.default_rng(0)
    n = 64
    args = [
        rng.normal(size=(n, 3)), rng.normal(size=(n, 12)), rng.uniform(-0.2, 0.2, (n, 12)),
        rng.normal(size=(n, 3)), rng.normal(0, 0.3, (n, 3, 3)), rng.normal(size=(n, 3)),
        rng.integers(0, 12, n), rng.uniform(-0.2, 0.2, n), rng.integers(0, 3, n),
        rng.normal(0, 0.3, (n, 3)),
    ]
    args = [a.astype(np.int32 if a.dtype.kind == "i" else np.float32) for a in args]
    args[5][: n // 2] = args[0][: n // 2] + 0.1 * args[5][: n // 2]  # overlapping pairs
    want = jax.jit(j_compute_box3d_iou)(*args)
    got = compute_box3d_iou(*(torch.from_numpy(a) for a in args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    assert (np.asarray(want[1]) > 0.05).sum() >= n // 4  # not a hollow comparison


def _random_outputs(rng, n, two_box):
    def head():
        hs = rng.normal(size=(B, 12)).astype(np.float32)
        hrn = rng.normal(0, 0.3, (B, 12)).astype(np.float32)
        ss = rng.normal(size=(B, 3)).astype(np.float32)
        srn = rng.normal(0, 0.3, (B, 3, 3)).astype(np.float32)
        return dict(heading_scores=hs, heading_residuals_normalized=hrn, size_scores=ss,
                    size_residuals_normalized=srn)

    out = {"logits": rng.normal(size=(B, n, 2)).astype(np.float32)}
    if not two_box:
        return {**out, **head(), "center": rng.normal(size=(B, 3)).astype(np.float32)}
    for tag in ("one", "two"):
        out.update({f"{k}_{tag}": v for k, v in head().items()})
        out[f"center_{tag}"] = rng.normal(size=(B, 3)).astype(np.float32) * 3
    out["heading_class_label_two"] = rng.integers(0, 12, B).astype(np.int32)
    out["heading_residuals_label_two"] = rng.uniform(-0.25, 0.25, B).astype(np.float32)
    return out


@pytest.mark.parametrize("kind", ["one_box", "two_box", "dynamic"])
def test_losses_match_tdal(kind):
    _, _, j_loss, t_loss, n, _, _, seed = CASES[kind]
    batch, _ = _batch(kind, seed)
    labels = {k: batch[k] for k in LABEL_KEYS}
    # large center errors reach huber's linear part, small ones its quadratic part
    out = _random_outputs(np.random.default_rng(seed), n, kind == "two_box")
    want = j_loss(out, labels)
    got = t_loss({k: torch.from_numpy(v) for k, v in out.items()},
                 {k: torch.from_numpy(v) for k, v in labels.items()})
    assert set(got) == set(want)
    for k, w in want.items():
        w = float(w)
        assert abs(float(got[k]) - w) <= LOSS_TOL * abs(w), (k, float(got[k]), w)


def _flat_state(model, tree_params, tree_bs):
    return {k: v.numpy() for k, v in flax_to_state_dict(model, tree_params, tree_bs).items()}


def _floored(got, want, noise, what):
    """|got - want| within GRAD_MARGIN x ``noise`` (the largest over the value) or TOL
    of max(1, |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = np.maximum(GRAD_MARGIN * float(np.max(noise)), TOL * np.maximum(1.0, np.abs(want)))
    err = np.abs(got - want)
    assert (err <= tol).all(), f"{what}: {(err / tol).max():.3f} of its tolerance"


def _unpermuted(tree):
    inv = np.argsort(PERMUTATION)
    return {k: (v[inv] if np.ndim(v) and len(v) == B else v) for k, v in tree.items()}


@pytest.mark.parametrize("kind", ["one_box", "two_box", "dynamic"])
def test_train_forward_matches_tdal(kind, tdal_draws):
    flax_model, model, j_loss, t_loss, params, bs, batch, draws = _setup(kind)
    j_out, j_losses, _, j_new_bs = _tdal_grads(flax_model, j_loss, params, bs, batch, draws,
                                               tdal_draws)
    p_out, p_losses, _, p_new_bs = _tdal_grads(flax_model, j_loss, params, bs,
                                               *_permuted(batch, draws), tdal_draws)
    p_out = _unpermuted(p_out)
    out, losses, _, _ = _port_step(model, t_loss, batch, draws, kind)
    # the seg masks (and so the gathered points) are equal element by element: a seg
    # logit on a knife edge would fail here, never pass
    mask = out["mask"].numpy()
    np.testing.assert_array_equal(mask, j_out["mask"])
    assert 0 < mask.sum(axis=1).min() and mask.sum(axis=1).max() < mask.shape[1]
    np.testing.assert_array_equal(p_out["mask"], j_out["mask"])
    assert set(out) == set(j_out)
    for k, v in j_out.items():
        if k != "mask":
            _floored(out[k].detach().numpy(), v, np.abs(p_out[k] - v), k)
    for k, v in j_losses.items():
        _floored(float(losses[k].detach()), float(v), abs(float(p_losses[k]) - float(v)), k)
    # the running statistics after the step (flax's biased variance, momentum 0.9)
    want = _flat_state(model, params, j_new_bs)
    perm = _flat_state(model, params, p_new_bs)
    for k, v in model.state_dict().items():
        if "running" in k:
            _floored(v.numpy(), want[k], np.abs(perm[k] - want[k]).max(), k)


@pytest.mark.parametrize("kind", ["one_box", "two_box", "dynamic"])
def test_train_step_matches_tdal(kind, tdal_draws):
    """One train step: gradients, the loss terms and metrics of tdal's ``make_steps``
    train step, and the parameters and running statistics after the adamw update."""
    flax_model, model, j_loss, t_loss, params, bs, batch, draws = _setup(kind)
    _, _, g, _ = _tdal_grads(flax_model, j_loss, params, bs, batch, draws, tdal_draws)
    perm_batch, perm_draws = _permuted(batch, draws)
    p_out, p_losses, g_perm, p_bs = _tdal_grads(flax_model, j_loss, params, bs, perm_batch,
                                                perm_draws, tdal_draws)
    p_metrics = {**p_losses, **_np(jax.jit(j_labeler_metrics)(
        p_out, {k: perm_batch[k] for k in LABEL_KEYS}))}
    want_g, perm_g = _flat_state(model, g, bs), _flat_state(model, g_perm, bs)
    names = [n for n, _ in model.named_parameters()]
    noise = {n: float(np.abs(want_g[n] - perm_g[n]).max()) for n in names}
    tol = {n: max(GRAD_MARGIN * noise[n], TOL * float(np.abs(want_g[n]).max()) + 1e-12)
           for n in names}

    tdal_draws(draws)
    tx = j_adam(j_step_decay(LR, 1), weight_decay=WEIGHT_DECAY)
    train_step, _ = j_make_steps(flax_model, j_loss, lambda b: _inputs_of(flax_model, b),
                                 donate=False)
    j_state, j_metrics = train_step(JTrainState.create(params, tx, bs), batch,
                                    jax.random.PRNGKey(0))
    want_state = _flat_state(model, _np(j_state.params), _np(j_state.batch_stats))
    perm_state = _flat_state(model, params, p_bs)

    old = {k: v.clone() for k, v in model.state_dict().items()}
    opt = adam_with_schedule(model.parameters(), labeler_step_decay(LR, 1), WEIGHT_DECAY)
    out, losses, grads, labels = _port_step(model, t_loss, batch, draws, kind, opt)
    metrics = {**{k: v.detach() for k, v in losses.items()}, **labeler_metrics(out, labels)}

    assert set(metrics) == set(j_metrics)
    for k, v in j_metrics.items():
        _floored(float(metrics[k]), float(v), abs(float(p_metrics[k]) - float(v)), k)
    for n in names:
        err = float(np.abs(grads[n].numpy() - want_g[n]).max())
        assert err <= tol[n], f"grad {n}: {err:.3e} > {tol[n]:.3e} (noise floor {noise[n]:.3e})"
    assert max(noise.values()) > 0  # the floor was measured, not assumed
    state = model.state_dict()
    for n in names:
        allowed = (1e-6 * (1 + np.abs(old[n].numpy()))
                   + (np.abs(want_g[n]) <= tol[n]) * 2.0 * LR)
        err = np.abs(state[n].numpy() - want_state[n])
        assert (err <= allowed).all(), f"param {n} after the update: {err.max():.3e}"
    for k, v in state.items():
        if "running" in k:
            _floored(v.numpy(), want_state[k], np.abs(perm_state[k] - want_state[k]), k)


def test_unbiased_running_variance_fails_the_comparison(tdal_draws):
    """The control: torch's own BatchNorm1d (unbiased variance into the running
    average) in the (B, C) stacks, with the same weights (chip_smoke's
    ``with_torch_batchnorm``), must fail the running statistics' comparison at batch 4
    (a 4/3 factor on the batch variance)."""
    import chip_smoke

    flax_model, model, j_loss, t_loss, params, bs, batch, draws = _setup("one_box")
    _, _, _, j_new_bs = _tdal_grads(flax_model, j_loss, params, bs, batch, draws, tdal_draws)
    want = _flat_state(model, params, j_new_bs)
    control = chip_smoke.with_torch_batchnorm(model)
    _port_step(control, t_loss, batch, draws, "one_box")
    errs = {k: float((np.abs(v.numpy() - want[k]) / np.maximum(1, np.abs(want[k]))).max())
            for k, v in control.state_dict().items() if "running_var" in k}
    assert max(errs.values()) > 100 * TOL, errs


def test_two_box_cascade_stops_gradients():
    """Head two's scores reach no parameter of the seg net or of head one: box one and
    the points re-canonicalised into its frame are detached (tdal :90-111)."""
    _, model, _, _, _, _, batch, draws = _setup("two_box")
    model.train()
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    out = model(t(batch["pts"]), t(batch["init_box"]), t(batch["bbox_gt"]),
                noise=t(draws["noise"]), keep=t(draws["keep"]))
    assert not out["box_one"].requires_grad
    (out["heading_scores_two"].sum() + out["size_residuals_two"].sum()).backward()
    for name, p in model.named_parameters():
        reached = p.grad is not None and bool(p.grad.abs().max() > 0)
        assert reached == name.startswith("box_est_two."), name
    # head one is still trained through the two-box loss: center_two adds center_one
    model.zero_grad(set_to_none=True)
    out = model(t(batch["pts"]), t(batch["init_box"]), t(batch["bbox_gt"]),
                noise=t(draws["noise"]), keep=t(draws["keep"]))
    out["center_two"].sum().backward()
    assert model.box_est_one.out.weight.grad.abs().max() > 0


def test_labeler_step_decay_matches_tdal():
    for args in ((1e-3, 3), (1e-3, 1, 2, 0.5, 2e-4)):
        want = j_step_decay(*args)
        got = labeler_step_decay(*args)
        lrs = [got(s) for s in range(200)]
        np.testing.assert_allclose(lrs, [float(want(s)) for s in range(200)], rtol=1e-6)
    # the floor rule: 1e-3 * 0.5^k reaches 2e-4 at k = 3, where the rate is 1e-5
    assert lrs[6] == pytest.approx(1e-5) and lrs[5] == pytest.approx(2.5e-4)


def _check_inputs(b=8, n=256):
    rng = np.random.default_rng(7)
    batch = {"pts": rng.normal(size=(b, n, 3)).astype(np.float32),
             "init_box": _boxes(rng, b), "bbox_gt": _boxes(rng, b),
             "mask_label": (rng.random((b, n)) < 0.5).astype(np.float32),
             "center_label": rng.normal(size=(b, 3)).astype(np.float32),
             "heading_class_label": rng.integers(0, 12, b).astype(np.int32),
             "heading_residuals_label": rng.uniform(-0.25, 0.25, b).astype(np.float32),
             "size_class_label": rng.integers(0, 3, b).astype(np.int32),
             "size_residuals_label": rng.normal(0, 0.3, (b, 3)).astype(np.float32)}
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    return [t["pts"], t["init_box"], t["bbox_gt"]], {k: t[k] for k in LABEL_KEYS}


def test_chip_smoke_labeler_step_check_and_its_control():
    """chip_smoke's phase-8 check of a labeler train step against a CPU copy, run with
    the CPU on both sides: the step passes with no error, and the control (torch's
    unbiased running variance) fails it on the running variance."""
    import chip_smoke
    from tdal_torch.pipeline.factories import make_labeler

    model, loss_fn, _, _ = make_labeler("one_box_est", 64, device="cpu", seed=2)
    inputs, labels = _check_inputs()
    out = chip_smoke.check_labeler_step_against_cpu("static", model, loss_fn, inputs, labels,
                                                    torch.device("cpu"))
    assert out["sound"]["grad_err_over_tol"] == 0 and out["knife_edge_sets"] == 0
    assert out["sets"] == 8 and len(out["noise_terms"]) >= 2
    assert out["control"]["stat_rel_err"] > 100 * chip_smoke.STAT_TOL


def test_parallel_batch_iterator_matches_tdal_and_batch_iterator():
    """The port's spawned-pool iterator yields tdal's batches, and batch_iterator's,
    in order (a dataset that draws nothing, so every worker builds the same items)."""
    from tdal.data.track_datasets import batch_iterator as j_batch_iterator
    from tdal_torch.data.track_datasets import batch_iterator, parallel_batch_iterator

    rng = np.random.default_rng(0)
    dataset = [{"pts": rng.normal(size=(5, 3)).astype(np.float32), "track_id": f"t{i}",
                "token": f"k{i}"} for i in range(11)]
    kw = dict(shuffle=True, seed=3, drop_last=False, pad_to_full=True)
    got = list(parallel_batch_iterator(dataset, 4, num_workers=2, **kw))
    for want in (list(j_batch_iterator(dataset, 4, **kw)), list(batch_iterator(dataset, 4, **kw))):
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.keys() == w.keys() and g["n_valid"] == w["n_valid"]
            assert g["track_id"] == w["track_id"]
            np.testing.assert_array_equal(g["pts"], w["pts"])
