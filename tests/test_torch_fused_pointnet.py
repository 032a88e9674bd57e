"""tdal_torch.ops.fused_pointnet (K1 + K2 and their twins) against tdal.

The twins against flax ``PointNetSeg.apply(train=False)`` (f32 operands) and
against the Pallas kernels in interpret mode (bf16 operands), on the CPU. The CUDA
kernels are held against the twins in tests/test_torch_kernels_gpu.py.

Tolerances:
- F32_TOL: f32 on both sides, same products summed in another order (XLA vs torch
  CPU); measured <= 1e-6 on these shapes.
- BF16_TOL: both sides round every operand to bf16 and accumulate in f32. A 1e-7
  summation-order difference occasionally moves an activation across a bf16
  rounding boundary before the next layer (one 2^-8 step); measured 9e-4 on logits
  of magnitude 0.2. 5e-3 is the tolerance tests/test_pallas_pointnet.py uses.
"""

import jax
import numpy as np
import pytest
import torch

from tdal.models.pointnet import PointNetSeg as FlaxPointNetSeg
from tdal.ops import pallas_pointnet as pallas
from tdal.runtime.train_state import init_model
from tdal_torch.convert import load_flax
from tdal_torch.models.pointnet import PointNetSeg
from tdal_torch.ops import fused_pointnet as fp

torch.set_num_threads(2)

F32_TOL = 1e-5
BF16_TOL = 5e-3


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def flax_variables(model, *inputs, seed=0):
    """flax (params, batch_stats) as numpy trees, with BatchNorm scale/shift and
    running stats drawn from ``seed`` so that folding has work to do."""
    key = jax.random.PRNGKey(seed)
    params, bs = init_model(model, {"params": key, "gather": key, "dropout": key}, *inputs)
    rng = np.random.default_rng(seed)
    params, bs = to_numpy(params), to_numpy(bs)

    def perturb(p, s):
        for k in p:
            if k.startswith("BatchNorm"):
                n = p[k]["scale"].shape
                p[k]["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
                p[k]["bias"] = (0.1 * rng.normal(size=n)).astype(np.float32)
                s[k]["mean"] = (0.1 * rng.normal(size=n)).astype(np.float32)
                s[k]["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            elif isinstance(p[k], dict) and k in s:
                perturb(p[k], s[k])

    perturb(params, bs)
    return params, bs


def _seg(cin, n, seed, b=2):
    pts = np.random.default_rng(seed).normal(size=(b, n, cin)).astype(np.float32)
    params, bs = flax_variables(FlaxPointNetSeg(), pts, seed=seed)
    model = load_flax(PointNetSeg(cin), params, bs).eval()
    return pts, params, bs, model


def test_fold_bn_matches_tdal():
    rng = np.random.default_rng(0)
    k, b = rng.normal(size=(8, 4)), rng.normal(size=4)
    scale, shift = rng.uniform(0.5, 1.5, 4), rng.normal(size=4)
    mean, var = rng.normal(size=4), rng.uniform(0.1, 2.0, 4)
    args = [a.astype(np.float32) for a in (k, b, scale, shift, mean, var)]
    w_ref, b_ref = pallas.fold_bn(*args)
    w, bb = fp.fold_bn(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bb.numpy(), np.asarray(b_ref), rtol=1e-6, atol=1e-6)


def test_fold_pointnet_seg_params_matches_tdal():
    _, params, bs, model = _seg(3, 64, seed=1)
    ref = pallas.fold_pointnet_seg_params(params, bs)
    got = fp.fold_pointnet_seg_params(model)
    for r_group, g_group in zip(ref, got):
        r_list = r_group if isinstance(r_group, (list, tuple)) else [r_group]
        g_list = g_group if isinstance(g_group, (list, tuple)) else [g_group]
        for r, g in zip(r_list, g_list, strict=True):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "cin,n",
    [(3, 256), (4, 300)],  # 300: not a multiple of any kernel tile (64, 32, 2048, 1024)
)
def test_twin_f32_matches_flax(cin, n):
    pts, params, bs, model = _seg(cin, n, seed=2 + cin)
    ref = np.asarray(
        FlaxPointNetSeg().apply({"params": params, "batch_stats": bs}, pts, train=False)
    )
    with torch.inference_mode():
        layers = model(torch.from_numpy(pts)).numpy()
        twin = fp.pointnet_seg_logits(fp.fold_pointnet_seg_params(model), torch.from_numpy(pts))
    np.testing.assert_allclose(layers, ref, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(twin.numpy(), ref, rtol=F32_TOL, atol=F32_TOL)


def test_twin_bf16_matches_pallas_interpret():
    pts, params, bs, model = _seg(3, 256, seed=7)
    folded_np = [to_numpy(x) for x in pallas.fold_pointnet_seg_params(params, bs)]
    skip_ref, gmax_ref = pallas.fused_seg_encoder(pts, folded_np[0], folded_np[1], interpret=True)
    ref = np.asarray(pallas.pointnet_seg_logits(params, bs, pts, interpret=True))
    with torch.inference_mode():
        folded = fp.fold_pointnet_seg_params(model)
        skip, gmax = fp.fused_seg_encoder(torch.from_numpy(pts), folded[0], folded[1], True)
        logits = fp.pointnet_seg_logits(folded, torch.from_numpy(pts), bf16_operands=True)
    # the encoder's five layers agree to f32 rounding (measured 5e-7 at |x| ~ 4)
    np.testing.assert_allclose(skip.numpy(), np.asarray(skip_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gmax.numpy(), np.asarray(gmax_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), ref, rtol=0, atol=BF16_TOL)


def test_cpu_tensors_run_the_twin_and_count_no_launch():
    pts, _, _, model = _seg(3, 64, seed=3)
    before = dict(fp.launches)
    with torch.inference_mode():
        fp.pointnet_seg_logits(fp.fold_pointnet_seg_params(model), torch.from_numpy(pts))
    assert fp.launches == before


def test_wrappers_raise_for_non_cpu_tensors():
    """A tensor that is not on the CPU never reaches the twin: the wrapper launches
    the kernel or raises (here: a meta tensor, no card)."""
    _, _, _, model = _seg(3, 64, seed=3)
    folded = fp.fold_pointnet_seg_params(model)
    meta = torch.empty(2, 64, 3, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        fp.fused_seg_encoder(meta, folded[0], folded[1])
    with pytest.raises(ValueError, match="CUDA tensor"):
        fp.fused_seg_decoder(
            torch.empty(2, 64, 64, device="meta"), torch.empty(2, 1024, device="meta"),
            *folded[2:],
        )
