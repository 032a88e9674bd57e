"""The fused PointNet-seg CUDA kernels (K1, K2) against their plain twins, on the card.

This file imports no jax, so it also runs where only PyTorch is installed:
``python -m pytest --noconftest -q tests/test_torch_kernels_gpu.py``. Without a card
every case skips.

Tolerances, relative to max(1, max |twin|):
- f32 operands: 1e-5; the kernel and the twin sum the same f32 products in another
  order (TF32 is off for the twin).
- bf16 operands: 2e-3; both round every operand to bf16, and a summation-order
  difference can move an activation across a bf16 rounding boundary (one 2^-8 step)
  before the next layer.
- In either mode the RMS error must also be at most 1/MODE_MARGIN of the mode gap:
  the RMS error of the same kernel run in the other operand mode against this mode's
  twin. The mode changes every value and a rounding step only a few, so a kernel
  that ignored ``bf16_operands`` would fail, which the largest error alone cannot
  show for K2 (its logits are small: the gap's largest error is below 1e-3).
"""

import pytest
import torch

from tdal_torch.ops import fused_pointnet as fp
from tdal_torch.pipeline.factories import random_pointnet_seg

torch.set_num_threads(2)

TOL = {False: 1e-5, True: 2e-3}
MODE_MARGIN = 10


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def max_rel_err(got, ref) -> float:
    return float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))


def rms_rel_err(got, ref) -> float:
    return float((got - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt().clamp_min(1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("cin,n", [(3, 1), (3, 64), (4, 100), (3, 4096), (4, 5120)])
def test_kernels_match_twins(cuda, cin, n, bf16):
    g = torch.Generator().manual_seed(n)
    x = torch.randn(3, n, cin, generator=g).to(cuda)
    model = random_pointnet_seg(cin, seed=cin).to(cuda)
    with torch.inference_mode():
        folded = fp.fold_pointnet_seg_params(model)
        before = dict(fp.launches)
        skip, gmax = fp.fused_seg_encoder(x, folded[0], folded[1], bf16)
        logits = fp.fused_seg_decoder(skip, gmax, *folded[2:], bf16)
        torch.cuda.synchronize()
        assert fp.launches["fused_seg_encoder"] == before["fused_seg_encoder"] + 1
        assert fp.launches["fused_seg_decoder"] == before["fused_seg_decoder"] + 1
        # the same kernels in the other operand mode, on the same inputs
        other = (*fp.fused_seg_encoder(x, folded[0], folded[1], not bf16),
                 fp.fused_seg_decoder(skip, gmax, *folded[2:], not bf16))
        skip_t, gmax_t = fp.fused_seg_encoder_plain(x, folded[0], folded[1], bf16)
        logits_t = fp.fused_seg_decoder_plain(skip, gmax, *folded[2:], bf16)
    for got, got_other, want in zip((skip, gmax, logits), other, (skip_t, gmax_t, logits_t)):
        assert max_rel_err(got, want) <= TOL[bf16]
        err, gap = rms_rel_err(got, want), rms_rel_err(got_other, want)
        assert MODE_MARGIN * err <= gap, (err, gap)


@pytest.mark.gpu
def test_pointnet_seg_eval_on_card_runs_the_kernels(cuda):
    model = random_pointnet_seg(3, seed=0).to(cuda)
    x = torch.randn(2, 300, 3, generator=torch.Generator().manual_seed(1)).to(cuda)
    before = dict(fp.launches)
    with torch.inference_mode():
        got = model(x)
        assert fp.launches["fused_seg_encoder"] == before["fused_seg_encoder"] + 1
        assert fp.launches["fused_seg_decoder"] == before["fused_seg_decoder"] + 1
        folded = fp.fold_pointnet_seg_params(model)
        skip, gmax = fp.fused_seg_encoder_plain(x, folded[0], folded[1])
        ref = fp.fused_seg_decoder_plain(skip, gmax, *folded[2:])
    assert max_rel_err(got, ref) <= TOL[False]


@pytest.mark.gpu
def test_wrappers_check_their_inputs(cuda):
    model = random_pointnet_seg(3, seed=0).to(cuda)
    folded = fp.fold_pointnet_seg_params(model)
    with pytest.raises(ValueError):
        fp.fused_seg_encoder(torch.zeros(2, 8, 5, device=cuda), folded[0], folded[1])
    with pytest.raises(TypeError):
        fp.fused_seg_encoder(torch.zeros(2, 8, 3, device=cuda, dtype=torch.float64),
                             folded[0], folded[1])
    with pytest.raises(ValueError):
        fp.fused_seg_encoder(torch.zeros(2, 3, 8, device=cuda).transpose(1, 2),
                             folded[0], folded[1])
