"""The port's CUDA kernels against their plain twins, on the card: the fused
PointNet-seg kernels (K1, K2) and the 3x3 conv kernels (K3, K4, K5/K6, K7, with their
tolerances below; also in their row halo form), one detector train step through them,
a chained pair on two ranks splitting the rows (BEV spatial partitioning), ``dist_test
--spatial_shards 2`` over NCCL where there are two cards, and phase 13 of
``chip_smoke.py`` (a checkpoint of tdal's read without orbax and served on the card).

This file imports no jax, so it also runs where only PyTorch is installed:
``python -m pytest --noconftest -q tests/test_torch_kernels_gpu.py``. Without a card
every case skips.

K1/K2 tolerances, relative to max(1, max |twin|):
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
@pytest.mark.parametrize("cin,n", [(3, 1), (3, 64), (4, 100), (3, 127), (4, 128), (3, 129),
                                   (4, 255), (3, 4096), (4, 5120)])
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
@pytest.mark.parametrize("bf16", [False, True])
def test_encoder_max_from_the_ragged_last_tile(cuda, bf16):
    """N = 2 tiles + 3 points, the last 3 scaled up so that the per-set maximum of most
    channels lies only in the ragged last tile (checked on the twin)."""
    tile = 128
    n = 2 * tile + 3
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, n, 3, generator=g)
    x[:, 2 * tile:] *= 20.0
    x = x.to(cuda)
    model = random_pointnet_seg(3, seed=3).to(cuda)
    with torch.inference_mode():
        folded = fp.fold_pointnet_seg_params(model)
        skip, gmax = fp.fused_seg_encoder(x, folded[0], folded[1], bf16)
        torch.cuda.synchronize()
        skip_t, gmax_t = fp.fused_seg_encoder_plain(x, folded[0], folded[1], bf16)
        _, gmax_head = fp.fused_seg_encoder_plain(x[:, :2 * tile], folded[0], folded[1], bf16)
    assert float((gmax_t > gmax_head).float().mean()) > 0.25
    assert max_rel_err(skip, skip_t) <= TOL[bf16]
    assert max_rel_err(gmax, gmax_t) <= TOL[bf16]


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n", [1, 37, 127])
def test_decoder_alone_below_one_tile(cuda, n, bf16):
    """K2 on N smaller than its 128-point tile, from a skip and gmax made up here."""
    g = torch.Generator().manual_seed(n)
    skip = torch.relu(torch.randn(3, n, 64, generator=g)).to(cuda)
    gmax = torch.relu(torch.randn(3, 1024, generator=g)).to(cuda)
    model = random_pointnet_seg(4, seed=1).to(cuda)
    with torch.inference_mode():
        folded = fp.fold_pointnet_seg_params(model)
        before = fp.launches["fused_seg_decoder"]
        logits = fp.fused_seg_decoder(skip, gmax, *folded[2:], bf16)
        torch.cuda.synchronize()
        assert fp.launches["fused_seg_decoder"] == before + 1
        want = fp.fused_seg_decoder_plain(skip, gmax, *folded[2:], bf16)
    assert logits.shape == (3, n, 2)
    assert max_rel_err(logits, want) <= TOL[bf16]


@pytest.mark.gpu
def test_pointnet_seg_eval_on_card_runs_the_kernels(cuda):
    """Through the weights it packed once, and again after they changed in place."""
    model = random_pointnet_seg(3, seed=0).to(cuda)
    x = torch.randn(2, 300, 3, generator=torch.Generator().manual_seed(1)).to(cuda)

    def reference():
        folded = fp.fold_pointnet_seg_params(model)
        skip, gmax = fp.fused_seg_encoder_plain(x, folded[0], folded[1])
        return fp.fused_seg_decoder_plain(skip, gmax, *folded[2:])

    before = dict(fp.launches)
    with torch.inference_mode():
        got = model(x)
        assert fp.launches["fused_seg_encoder"] == before["fused_seg_encoder"] + 1
        assert fp.launches["fused_seg_decoder"] == before["fused_seg_decoder"] + 1
        ref = reference()
    assert max_rel_err(got, ref) <= TOL[False]
    with torch.no_grad():
        model.dec.bn[1].running_var.mul_(16.0)
    with torch.inference_mode():
        changed, ref_changed = model(x), reference()
    assert max_rel_err(changed, ref) > 100 * TOL[False]
    assert max_rel_err(changed, ref_changed) <= TOL[False]


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
def test_weight_streams_have_the_kernels_size(cuda, bf16):
    """The packer's streams are the size the kernels read; a stream of another size
    is refused before the launch."""
    from tdal_torch.ops.build import kernels

    lib = kernels()
    folded = fp.fold_pointnet_seg_params(random_pointnet_seg(4, seed=2).to(cuda))
    enc, dec = fp.seg_weight_streams(folded, bf16)
    for stream, decoder in ((enc, False), (dec, True)):
        assert stream.numel() * stream.element_size() == lib.seg_stream_bytes(decoder, bf16)
    x = torch.randn(2, 64, 4, device=cuda)
    with pytest.raises(RuntimeError, match="weight stream"):
        fp.fused_seg_encoder(x, folded[0], folded[1], bf16, enc[:-8])


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


# ---------------------------------------------------------------------------
# The 3x3 conv kernels K3, K4, K5/K6, K7 (tdal_torch/ops/csrc/conv3x3.cu)
#
# Tolerances, relative to max(1, max |twin|): 1e-5 for every f32 output and for the
# bf16 moments and wgrad (f32 accumulators of the same exact products, summed in
# another order); 8e-3 for bf16 y and dgrad (K4's and K7's dx), one bf16 rounding step
# (2^-7 of the largest value) that a summation-order difference can flip. K7's ds and
# dt: 1e-5 of sum |dxh * x| and of sum |dxh| per channel (f32 sums of the same terms
# in another order; a signed sum can be far smaller than its terms).
# ---------------------------------------------------------------------------

from tdal_torch.ops import conv3x3 as cv  # noqa: E402

CONV_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (8e-3, 1e-5)}  # (y/dx, stats/dw)


def dgrad_act_stats_err(got, x, gy, wt, s, t):
    """K7's statistics (2, C) against its twin's, each channel's error over the sum of
    the absolute terms: (sum |dxh * x|, sum |dxh|)."""
    _, want = cv.conv3x3_dgrad_act_plain(gy, wt, x, s, t)
    dxh = cv._conv_f32(gy.float(), wt.float()) * (x.float() * s + t > 0)
    scale = torch.stack([(dxh * x.float()).abs().sum(dim=(0, 1, 2)),
                         dxh.abs().sum(dim=(0, 1, 2))])
    return float(((got - want).abs() / scale.clamp_min(1e-30)).max())


def _conv_inputs(cuda, b, h, w, c, co, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, w, c, generator=g).to(dtype)
    wt = (torch.randn(3, 3, c, co, generator=g) / (3 * c ** 0.5)).to(dtype)
    bias = torch.randn(co, generator=g)
    s = 0.5 + torch.rand(c, generator=g)
    t = 0.5 + torch.rand(c, generator=g)  # positive shifts: a halo leak shows
    gy = torch.randn(b, h, w, co, generator=g).to(dtype)
    return [a.to(cuda) for a in (x, wt, bias, s, t, gy)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("in_act", [False, True])
# (B, H, W, C, Co): ragged channel counts (5->7 and 33->130 take the element copies);
# C = Co = 1; 384->64, many K slices at a small image; an image whose H and W are not
# multiples of the 8x16 block tile, with the 16-byte copies
# the VoxelNet RPN's stride-1 sites (188^2 128->128, 94^2 256->256) and its head's
# shared conv (188^2 512->64), at batch 1
@pytest.mark.parametrize("shape", [(2, 8, 9, 5, 7), (1, 37, 41, 20, 70), (2, 32, 48, 64, 64),
                                   (1, 17, 20, 33, 130), (2, 5, 7, 1, 1),
                                   (1, 12, 20, 384, 64), (2, 11, 35, 64, 64),
                                   (1, 188, 188, 128, 128), (1, 94, 94, 256, 256),
                                   (1, 188, 188, 512, 64)])
def test_conv_kernels_match_twins(cuda, shape, in_act, dtype):
    x, w, b, s, t, gy = _conv_inputs(cuda, *shape, dtype)
    tol_y, tol_acc = CONV_TOL[dtype]
    before = dict(cv.launches)
    y, stats = cv.conv3x3_fwd_stats(x, w, b, s, t, in_act)
    wt = cv._flip_swap(w)
    dx = cv.conv3x3_fwd(gy, wt, torch.zeros(shape[3], device=cuda))
    dw = cv.conv3x3_wgrad(x, gy, s, t, in_act)
    torch.cuda.synchronize()
    assert {k: cv.launches[k] - before[k] for k in before} == {
        "conv3x3_fwd_stats": 1, "conv3x3_fwd": 1, "conv3x3_wgrad": 1, "conv3x3_dgrad_act": 0}
    y_t, stats_t = cv.conv3x3_fwd_stats_plain(x, w, b, s, t, in_act)
    assert y.dtype == dtype and max_rel_err(y.float(), y_t.float()) <= tol_y
    assert max_rel_err(stats, stats_t) <= tol_acc
    dx_t = cv.conv3x3_fwd_plain(gy, wt, torch.zeros(shape[3], device=cuda))
    assert max_rel_err(dx.float(), dx_t.float()) <= tol_y
    assert max_rel_err(dw, cv.conv3x3_wgrad_plain(x, gy, s, t, in_act)) <= tol_acc
    if in_act:  # K7; shifts of both signs, so that the mask varies
        t = t - 1.0
        dx, st = cv.conv3x3_dgrad_act(gy, wt, x, s, t)
        torch.cuda.synchronize()
        assert cv.launches["conv3x3_dgrad_act"] == before["conv3x3_dgrad_act"] + 1
        dx_t, _ = cv.conv3x3_dgrad_act_plain(gy, wt, x, s, t)
        assert dx.dtype == dtype and max_rel_err(dx.float(), dx_t.float()) <= tol_y
        assert dgrad_act_stats_err(st, x, gy, wt, s, t) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("in_act", [False, True])
def test_conv_autograd_on_card_matches_the_cpu(cuda, in_act):
    """conv3x3_act_stats forward and its five gradients (K3, K5 and K7 or K4 on the
    card) against the same op on the CPU (the twins), f32."""
    x, w, b, s, t, gy = _conv_inputs(torch.device("cpu"), 2, 19, 23, 12, 24, torch.float32)
    gs = torch.randn(2, 24, generator=torch.Generator().manual_seed(3))
    grads = []
    for dev in (cuda, torch.device("cpu")):
        args = [a.to(dev).requires_grad_() for a in (x, w, b, s, t)]
        y, st = cv.conv3x3_act_stats(*args, in_act)
        ((y * gy.to(dev)).sum() + (st * gs.to(dev)).sum() * 1e-3).backward()
        grads.append([y.detach().cpu(), st.detach().cpu()] + [a.grad.cpu() for a in args])
    for got, want in zip(*grads):
        assert max_rel_err(got, want) <= 1e-4


HALOS = [(1, 0), (0, 1), (1, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("in_act", [False, True])
@pytest.mark.parametrize("halo", HALOS, ids=lambda h: f"halo{h[0]}{h[1]}")
# the 16-byte copies, and ragged channels (element copies) on an image whose rows are
# not a multiple of the 8-row tile
@pytest.mark.parametrize("shape", [(2, 13, 21, 16, 24), (1, 9, 11, 5, 7)])
def test_conv_halo_forms_match_twins(cuda, shape, halo, in_act, dtype):
    """The row halo form of K3, K4 (forward and as the dgrad), K5/K6 and K7 against
    their twins with the same ``halo``: (1, 0) is a slab at the image's bottom edge,
    (0, 1) at its top edge, (1, 1) inside; the input affine on or off (K3's halo rows
    take it, the padding never). Each call counts once in ``launches`` and in
    ``halo_launches``."""
    b_, h, w_, c, co = shape
    top, bottom = halo
    x, w, b, s, t, gy = _conv_inputs(cuda, b_, h + top + bottom, w_, c, co, dtype)
    g = gy[:, top : top + h].contiguous()  # the own rows' cotangent
    xo = x[:, top : top + h].contiguous()  # the own rows of the input
    tol_y, tol_acc = CONV_TOL[dtype]
    before, before_halo = dict(cv.launches), dict(cv.halo_launches)
    wt = cv._flip_swap(w)
    zero = torch.zeros(c, device=cuda)
    y, stats = cv.conv3x3_fwd_stats(x, w, b, s, t, in_act, halo)
    y4 = cv.conv3x3_fwd(x, w, b, None, in_act, halo)  # K4 with a shift and ReLU
    dx = cv.conv3x3_fwd(gy, wt, zero, halo=halo)
    dw = cv.conv3x3_wgrad(x, g, s, t, in_act, halo)
    t7 = t - 1.0  # shifts of both signs, so that K7's mask varies
    dx7, st7 = cv.conv3x3_dgrad_act(gy, wt, xo, s, t7, halo)
    torch.cuda.synchronize()
    ones = {"conv3x3_fwd_stats": 1, "conv3x3_fwd": 2, "conv3x3_wgrad": 1,
            "conv3x3_dgrad_act": 1}
    assert {k: cv.launches[k] - before[k] for k in before} == ones
    assert {k: cv.halo_launches[k] - before_halo[k] for k in before_halo} == ones
    assert y.shape == (b_, h, w_, co) and dx.shape == dx7.shape == (b_, h, w_, c)
    y_t, stats_t = cv.conv3x3_fwd_stats_plain(x, w, b, s, t, in_act, halo)
    assert max_rel_err(y.float(), y_t.float()) <= tol_y
    assert max_rel_err(stats, stats_t) <= tol_acc
    y4_t = cv.conv3x3_fwd_plain(x, w, b, None, in_act, halo)
    assert max_rel_err(y4.float(), y4_t.float()) <= tol_y
    assert max_rel_err(dx.float(), cv.conv3x3_fwd_plain(gy, wt, zero, halo=halo).float()) \
        <= tol_y
    assert max_rel_err(dw, cv.conv3x3_wgrad_plain(x, g, s, t, in_act, halo)) <= tol_acc
    dx7_t, st7_t = cv.conv3x3_dgrad_act_plain(gy, wt, xo, s, t7, halo)
    assert max_rel_err(dx7.float(), dx7_t.float()) <= tol_y
    dxh = cv._conv_f32(gy.float(), wt.float(), halo) * (xo.float() * s + t7 > 0)
    scale = torch.stack([(dxh * xo.float()).abs().sum(dim=(0, 1, 2)),
                         dxh.abs().sum(dim=(0, 1, 2))])
    assert float(((st7 - st7_t).abs() / scale.clamp_min(1e-30)).max()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_conv_halo_zero_launches_the_whole_image_kernel(cuda, dtype):
    """``halo=(0, 0)`` is the whole-image entry point (no halo launch counted), bit for
    bit the call without ``halo``; and the halo form on a slab with its neighbours'
    rows gives the whole image's rows (K3 with the input affine: the halo rows take it,
    which zero padding there would not)."""
    x, w, b, s, t, gy = _conv_inputs(cuda, 2, 24, 20, 16, 32, dtype)
    before = dict(cv.halo_launches)
    y0, st0 = cv.conv3x3_fwd_stats(x, w, b, s, t, True, (0, 0))
    y1, st1 = cv.conv3x3_fwd_stats(x, w, b, s, t, True)
    dw0 = cv.conv3x3_wgrad(x, gy, s, t, True, (0, 0))
    dw1 = cv.conv3x3_wgrad(x, gy, s, t, True)
    torch.cuda.synchronize()
    assert cv.halo_launches == before
    assert torch.equal(y0, y1) and torch.equal(st0, st1) and torch.equal(dw0, dw1)
    ys = [cv.conv3x3_fwd_stats(x[:, max(a - 1, 0) : min(bb + 1, 24)].contiguous(), w, b, s,
                               t, True, (int(a > 0), int(bb < 24)))[0]
          for a, bb in ((0, 7), (7, 16), (16, 24))]
    tol_y = CONV_TOL[dtype][0]
    assert max_rel_err(torch.cat(ys, 1).float(), y1.float()) <= tol_y


@pytest.mark.gpu
def test_conv_wrappers_check_their_inputs(cuda):
    x, w, b, s, t, _ = _conv_inputs(cuda, 1, 8, 8, 4, 4, torch.float32)
    with pytest.raises(TypeError):
        cv.conv3x3_fwd_stats(x.double(), w, b, s, t, False)
    with pytest.raises(TypeError):
        cv.conv3x3_fwd_stats(x, w.bfloat16(), b, s, t, False)
    with pytest.raises(ValueError):
        cv.conv3x3_fwd_stats(x.transpose(1, 2), w, b, s, t, False)
    with pytest.raises(ValueError):
        cv.conv3x3_fwd(x, w[:, :, :3], b)
    gy = torch.zeros_like(x)
    with pytest.raises(ValueError):
        cv.conv3x3_dgrad_act(gy, w, x[:, :4], s, t)
    with pytest.raises(TypeError):
        cv.conv3x3_dgrad_act(gy, w, x.bfloat16(), s, t)
    with pytest.raises(TypeError):
        cv.conv3x3_dgrad_act(gy, w, x, s.double(), t)


@pytest.mark.gpu
def test_detector_train_step_on_card_runs_the_kernels(cuda):
    """One train step of a narrow PointPillars on the card: every stride-1 3x3 conv
    of the trunk and the head is one K3 forward and one K5 + one dgrad in the backward
    (K7 where the conv takes its producer's BN + ReLU, K4 elsewhere), and the loss
    matches the same step on a CPU copy."""
    import copy

    import numpy as np

    from tdal_torch.core.voxel import VoxelConfig
    from tdal_torch.models.detectors import PointPillars
    from tdal_torch.models.builder import init_detector
    from tdal_torch.models.layers import FusedConvBN
    from tdal_torch.models.center_head import center_head_loss

    torch.backends.cudnn.allow_tf32 = False
    vox = VoxelConfig((-8.0, -8.0, -2.0, 8.0, 8.0, 4.0), (0.25, 0.25, 6.0), 8, 2000)
    tasks = [dict(num_class=3, class_names=("VEHICLE", "PEDESTRIAN", "CYCLIST"))]
    model = init_detector(PointPillars(vox, tasks, num_filters=(16, 16),
                                       rpn_layer_nums=(2, 2, 2), rpn_ds_filters=(32, 64, 64),
                                       rpn_us_filters=(32, 32, 32)),
                          torch.Generator().manual_seed(0))
    sites = sum(isinstance(m, FusedConvBN) for m in model.modules())
    # the chained sites: all but each RPN stage's and the head's first conv
    chained = sites - len(model.rpn.blocks) - 1
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.uniform(-8, 8, (2, 3000, 5)).astype(np.float32))
    hm = torch.zeros(2, 64, 64, 3)
    hm[:, 10:14, 20:24, 0] = 0.5
    tg = {"hm": [hm], "anno_box": [torch.randn(2, 4, 8)],
          "ind": [torch.randint(0, 4096, (2, 4))],
          "mask": [torch.ones(2, 4, dtype=torch.uint8)],
          "cat": [torch.zeros(2, 4, dtype=torch.long)]}
    losses = []
    for dev in (cuda, torch.device("cpu")):
        m = copy.deepcopy(model).to(dev).train()
        before = dict(cv.launches)
        total, _ = center_head_loss(m(pts.to(dev)),
                                    {k: [v.to(dev) for v in vs] for k, vs in tg.items()},
                                    [1.0] * 8)
        total.backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert {k: cv.launches[k] - before[k] for k in before} == {
                "conv3x3_fwd_stats": sites, "conv3x3_fwd": sites - chained,
                "conv3x3_dgrad_act": chained, "conv3x3_wgrad": sites}
        losses.append(float(total.detach()))
    assert np.isfinite(losses[0]) and losses[0] == pytest.approx(losses[1], rel=1e-4)


@pytest.mark.gpu
def test_gt_aug_train_step_on_card_runs_the_kernels(cuda, tmp_path):
    """One train step of pp_tiny (a narrow PointPillars) on a batch that the GT-aug
    sampler filled, from a database that ``create_data``'s ``waymo_data_prep`` wrote,
    through ``train``'s ``build_train_dataset``: on the card it launches K3, K5 and K7 or
    K4 at every stride-1 3x3 conv, and its loss matches the same step on a CPU copy."""
    import copy
    from pathlib import Path

    import numpy as np

    from tdal_torch.data.detection import collate_detection
    from tdal_torch.data.synthetic import SyntheticScene
    from tdal_torch.data.waymo_schema import load_pickle
    from tdal_torch.models.builder import build_assigner, build_detector, build_voxel_config
    from tdal_torch.models.center_head import center_head_loss
    from tdal_torch.models.layers import FusedConvBN
    from tdal_torch.pipeline.detector_engine import TARGET_KEYS, batch_to_device
    from tdal_torch.runtime.config import Config
    from tdal_torch.tools.create_data import waymo_data_prep
    from tdal_torch.tools.train import build_train_dataset

    torch.backends.cudnn.allow_tf32 = False
    for i in range(2):
        SyntheticScene(i, n_frames=4, seed=5, n_static=3, n_dynamic=1, points_per_object=64,
                       n_background=512).write(tmp_path, split="train")
    waymo_data_prep(tmp_path)
    cfg = Config.fromfile(Path(__file__).resolve().parent.parent / "configs/synthetic/pp_tiny.py")
    cfg.train_preprocessor["db_sampler"] = dict(
        enable=True, db_info_path=str(tmp_path / "dbinfos_train_1sweeps_withvelo.pkl"),
        sample_groups=[dict(VEHICLE=15)], db_prep_steps=[dict(filter_by_min_num_points=dict(
            VEHICLE=5))], rate=1.0)
    # without the velocity head, as tests/test_torch_parallel.py: the synthetic boxes'
    # 8-wide targets train none
    head = dict(cfg.model["bbox_head"])
    head["common_heads"] = {k: v for k, v in head["common_heads"].items() if k != "vel"}
    vox = build_voxel_config(cfg.voxel_generator, train=True)
    model = build_detector(dict(cfg.model, bbox_head=head), vox, device="cpu", seed=0)
    ds = build_train_dataset(cfg, load_pickle(tmp_path / "infos_train_01sweeps_filter_zero_gt.pkl"),
                             build_assigner(cfg.assigner, model), vox, seed=0)
    gt = [len(ds.infos[i]["gt_boxes"]) for i in (0, 5)]
    batch = collate_detection([ds[0], ds[5]])
    assert int(batch["mask"][0].sum()) > sum(gt)  # boxes were pasted
    sites = sum(isinstance(m, FusedConvBN) for m in model.modules())
    chained = sites - len(model.rpn.blocks) - 1
    losses = []
    for dev in (cuda, torch.device("cpu")):
        m = copy.deepcopy(model).to(dev).train()
        b = batch_to_device(batch, dev)
        before = dict(cv.launches)
        total, _ = center_head_loss(m(b["points"]), {k: b[k] for k in TARGET_KEYS},
                                    [1.0] * 8)
        total.backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert {k: cv.launches[k] - before[k] for k in before} == {
                "conv3x3_fwd_stats": sites, "conv3x3_fwd": sites - chained,
                "conv3x3_dgrad_act": chained, "conv3x3_wgrad": sites}
        losses.append(float(total.detach()))
    assert np.isfinite(losses[0]) and losses[0] == pytest.approx(losses[1], rel=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("model_type", ["one_box_est", "dynamic"])
def test_labeler_train_step_on_card_matches_the_cpu(cuda, model_type):
    """One labeler train step on the card (plain layers: K1/K2 are eval-only) against
    the same step on a CPU copy, by chip_smoke's phase-8 check (loss, gradients within a
    measured noise floor, BN running statistics, parameters after the update), and its
    control (torch's unbiased running variance) fails."""
    import numpy as np

    import chip_smoke
    from tdal_torch.pipeline.factories import make_labeler

    model, loss_fn, _, _ = make_labeler(model_type, 128, device=cuda, seed=3)
    rng = np.random.default_rng(5)
    b, n = 8, (512 if model_type != "dynamic" else 5 * 128)
    box = lambda: np.concatenate([rng.normal(size=(b, 3)), rng.uniform(1, 5, (b, 3)),  # noqa: E731
                                  rng.uniform(-3, 3, (b, 1))], 1).astype(np.float32)
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    if model_type == "dynamic":
        inputs = [t(rng.normal(size=(b, n, 4)).astype(np.float32)),
                  t(rng.normal(size=(b, 101, 8)).astype(np.float32)), t(box())]
    else:
        inputs = [t(rng.normal(size=(b, n, 3)).astype(np.float32)), t(box()), t(box())]
    labels = {"mask_label": t((rng.random((b, n)) < 0.5).astype(np.float32)),
              "center_label": t(rng.normal(size=(b, 3)).astype(np.float32)),
              "heading_class_label": t(rng.integers(0, 12, b).astype(np.int32)),
              "heading_residuals_label": t(rng.uniform(-0.25, 0.25, b).astype(np.float32)),
              "size_class_label": t(rng.integers(0, 3, b).astype(np.int32)),
              "size_residuals_label": t(rng.normal(0, 0.3, (b, 3)).astype(np.float32))}
    out = chip_smoke.check_labeler_step_against_cpu(model_type, model, loss_fn, inputs,
                                                    labels, cuda)
    assert out["sound"]["grad_err_over_tol"] <= 1 and out["control"]["stat_rel_err"] > 1e-3


@pytest.mark.gpu
def test_offboard_label_chain_on_card_runs_the_kernels(cuda, tmp_path):
    """Stages 2-6 of the offboard driver on the card from fabricated detections: tracks,
    a static/dynamic split and labeled boxes, with K1 and K2 launched once per predict
    batch."""
    import logging

    from tdal_torch.data.synthetic import fabricate_detections, make_synthetic_dataset
    from tdal_torch.data.waymo_schema import AnnoStore, reorganize_info
    from tdal_torch.pipeline.factories import make_labeler
    from tdal_torch.pipeline.offboard import label_chain

    infos, scenes = make_synthetic_dataset(tmp_path / "seg", n_scenes=1, n_frames=10, seed=0,
                                           n_static=3, n_dynamic=3, points_per_object=128,
                                           n_background=2000)
    info_map = reorganize_info(infos)
    annos = AnnoStore(info_map)
    labelers = tuple((m, i, k) for m, _, i, k in (make_labeler("one_box_est", device=cuda),
                                                   make_labeler("dynamic", device=cuda)))
    before = dict(fp.launches)
    res = label_chain(fabricate_detections(scenes, annos), info_map, annos, labelers,
                      tmp_path / "out", logging.getLogger("t"), score_thresh=0.5,
                      npoints_static=512, npoints_dynamic=128, predict_batch=8)
    counts = res["counts"]
    assert counts["static_boxes_labeled"] > 0 and counts["dynamic_boxes_labeled"] > 0, counts
    assert {k: fp.launches[k] - before[k] for k in before} == {
        k: counts["predict_batches"] for k in before}


# ---------------------------------------------------------------------------
# The sparse 3D convs (plain PyTorch: gathers and matmuls) on the card against the same
# ops on the CPU: tables and sites exactly equal; outputs and gradients within 1e-5 of
# max(1, |cpu|) (f32 sums in another order, TF32 off); a backward repeated on the card
# equal bit for bit (no atomics).
# ---------------------------------------------------------------------------


def _sparse_case(grid=(5, 40, 48), v=3000, n=(2400, 1700), c=16, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    coords = np.full((len(n), v, 3), -1, np.int64)
    valid = np.zeros((len(n), v), bool)
    for i, k in enumerate(n):
        lin = rng.choice(int(np.prod(grid)), k, replace=False)
        coords[i, :k] = np.stack([lin // (grid[1] * grid[2]), (lin // grid[2]) % grid[1],
                                  lin % grid[2]], 1)
        valid[i, :k] = True
    feats = rng.normal(size=(len(n), v, c)).astype(np.float32) * valid[..., None]
    return grid, torch.from_numpy(coords), torch.from_numpy(feats), torch.from_numpy(valid)


def _sparse_chain(sc, grid, coords, feats, valid, weights, device):
    """sort -> subm -> down2 -> downz -> BEV on ``device``: (integer results, BEV,
    gradients of feats and the three weights)."""
    c, f, v, k = sc.sort_voxels(*(t.to(device) for t in (coords, feats, valid)), grid)
    f = f.clone().requires_grad_()
    ws = [w.to(device).requires_grad_() for w in weights]
    nb = sc.subm_neighbors(c, v, k, grid)
    y = sc.subm_conv3d(c, f, v, k, grid, ws[0], neighbors=nb)
    c2, y2, v2, k2 = sc.sparse_conv3d_down2(c, y, v, k, grid, ws[1], 1200)
    g2 = sc.down2_grid(grid)
    c3, y3, v3, k3 = sc.sparse_conv3d_downz(c2, y2, v2, k2, g2, ws[2], 1200)
    bev = sc.scatter_dense_bev(c3, y3, v3, sc.downz_grid(g2))
    (bev * torch.linspace(-1, 1, bev.shape[-1], device=device)).sum().backward()
    ints = [t.cpu() for t in (c, v, k, *nb, c2, v2, k2, c3, v3, k3)]
    return ints, bev.detach().cpu(), [f.grad.cpu()] + [w.grad.cpu() for w in ws]


@pytest.mark.gpu
def test_sparse_convs_on_card_match_the_cpu(cuda):
    from tdal_torch.ops import sparse_conv as sc

    grid, coords, feats, valid = _sparse_case()
    g = torch.Generator().manual_seed(1)
    weights = [torch.randn(27, 16, 16, generator=g) / 20, torch.randn(27, 16, 32, generator=g) / 20,
               torch.randn(3, 32, 32, generator=g) / 10]
    card = _sparse_chain(sc, grid, coords, feats, valid, weights, cuda)
    again = _sparse_chain(sc, grid, coords, feats, valid, weights, cuda)
    cpu = _sparse_chain(sc, grid, coords, feats, valid, weights, torch.device("cpu"))
    for a, b in zip(card[0], cpu[0]):
        assert torch.equal(a, b)
    assert int(card[0][7].sum()) > 1000  # many level-1 sites
    assert max_rel_err(card[1], cpu[1]) <= 1e-5
    for a, b, c in zip(card[2], cpu[2], again[2]):
        assert max_rel_err(a, b) <= 1e-5
        assert torch.equal(a, c)  # the backward repeats bit for bit
    assert torch.equal(card[1], again[1])


@pytest.mark.gpu
def test_voxelnet_train_step_on_card_runs_the_kernels(cuda):
    """One train step of a narrow VoxelNet (the sparse backbone on a (8, 64, 64) grid)
    on the card: every stride-1 3x3 conv of the RPN and head is one K3 forward, one
    K5 and one dgrad (K7 where chained, K4 elsewhere), and the loss matches the same
    step on a CPU copy."""
    import copy

    import numpy as np

    from tdal_torch.core.voxel import VoxelConfig
    from tdal_torch.models.builder import init_detector
    from tdal_torch.models.center_head import center_head_loss
    from tdal_torch.models.detectors import VoxelNet
    from tdal_torch.models.layers import FusedConvBN

    torch.backends.cudnn.allow_tf32 = False
    vox = VoxelConfig((-8.0, -8.0, -2.0, 8.0, 8.0, 4.0), (0.25, 0.25, 0.75), 5, 4000)
    tasks = [dict(num_class=3, class_names=("VEHICLE", "PEDESTRIAN", "CYCLIST"))]
    model = init_detector(VoxelNet(vox, tasks, rpn_layer_nums=(2, 2), rpn_ds_filters=(32, 64),
                                   rpn_us_filters=(32, 32), sparse_middle=True),
                          torch.Generator().manual_seed(0))
    sites = sum(isinstance(m, FusedConvBN) for m in model.modules())
    # chained: all but the stride-1 stage's entry, the strided stage's first layer and
    # the head's shared conv
    chained = sites - 3
    rng = np.random.default_rng(0)
    pts = rng.uniform(-8, 8, (2, 3000, 5)).astype(np.float32)
    pts[..., 2] = rng.uniform(-1.9, 3.9, (2, 3000))
    pts = torch.from_numpy(pts)
    hm = torch.zeros(2, 8, 8, 3)
    hm[:, 2:4, 3:5, 0] = 0.5
    tg = {"hm": [hm], "anno_box": [torch.randn(2, 4, 8)], "ind": [torch.randint(0, 64, (2, 4))],
          "mask": [torch.ones(2, 4, dtype=torch.uint8)], "cat": [torch.zeros(2, 4, dtype=torch.long)]}
    losses = []
    for dev in (cuda, torch.device("cpu")):
        m = copy.deepcopy(model).to(dev).train()
        before = dict(cv.launches)
        total, _ = center_head_loss(m(pts.to(dev)),
                                    {k: [v.to(dev) for v in vs] for k, vs in tg.items()},
                                    [1.0] * 8)
        total.backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert {k: cv.launches[k] - before[k] for k in before} == {
                "conv3x3_fwd_stats": sites, "conv3x3_fwd": sites - chained,
                "conv3x3_dgrad_act": chained, "conv3x3_wgrad": sites}
        losses.append(float(total.detach()))
    assert np.isfinite(losses[0]) and losses[0] == pytest.approx(losses[1], rel=1e-4)


@pytest.mark.gpu
def test_dcn_voxelnet_train_step_on_card_runs_the_kernels(cuda):
    """One train step of a narrow deformable-head VoxelNet with the velocity head (the
    sparse backbone on a (8, 64, 64) grid, two sweeps' six point features, the offset
    convs' biases off zero) on the card: every stride-1 3x3 conv is one K3 forward, one
    K5 and one dgrad (K7 where chained; K4 at the stride-1 stage's entry, the strided
    stage's first layer, the shared conv and the regression SepHead's first conv, which
    the deformable head feeds unchained), and the loss and the deformable head's
    gradients match the same step on a CPU copy."""
    import copy

    import numpy as np

    from tdal_torch.core.voxel import VoxelConfig
    from tdal_torch.models.builder import init_detector
    from tdal_torch.models.center_head import center_head_loss
    from tdal_torch.models.dcn import FeatureAdaption
    from tdal_torch.models.detectors import VoxelNet
    from tdal_torch.models.layers import FusedConvBN

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    vox = VoxelConfig((-8.0, -8.0, -2.0, 8.0, 8.0, 4.0), (0.25, 0.25, 0.75), 5, 4000)
    tasks = [dict(num_class=3, class_names=("VEHICLE", "PEDESTRIAN", "CYCLIST"))]
    model = init_detector(VoxelNet(vox, tasks, num_input_features=6, rpn_layer_nums=(2, 2),
                                   rpn_ds_filters=(32, 64), rpn_us_filters=(32, 32),
                                   with_velocity=True, sparse_middle=True, dcn_head=True),
                          torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FeatureAdaption):
                m.offset.bias.uniform_(-0.3, 0.3, generator=gen)
    sites = sum(isinstance(m, FusedConvBN) for m in model.modules())
    chained = sites - 4
    rng = np.random.default_rng(0)
    pts = rng.uniform(-8, 8, (2, 3000, 6)).astype(np.float32)
    pts[..., 2] = rng.uniform(-1.9, 3.9, (2, 3000))
    pts[..., 5] = np.repeat([0.0, 0.1], 1500)
    pts = torch.from_numpy(pts)
    hm = torch.zeros(2, 8, 8, 3)
    hm[:, 2:4, 3:5, 0] = 0.5
    tg = {"hm": [hm], "anno_box": [torch.randn(2, 4, 10)],
          "ind": [torch.randint(0, 64, (2, 4))], "mask": [torch.ones(2, 4, dtype=torch.uint8)],
          "cat": [torch.zeros(2, 4, dtype=torch.long)]}
    losses, grads = [], []
    for dev in (cuda, torch.device("cpu")):
        m = copy.deepcopy(model).to(dev).train()
        before = dict(cv.launches)
        total, _ = center_head_loss(m(pts.to(dev)),
                                    {k: [v.to(dev) for v in vs] for k, vs in tg.items()},
                                    [1.0] * 10, has_vel=True)
        total.backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert {k: cv.launches[k] - before[k] for k in before} == {
                "conv3x3_fwd_stats": sites, "conv3x3_fwd": sites - chained,
                "conv3x3_dgrad_act": chained, "conv3x3_wgrad": sites}
        losses.append(float(total.detach()))
        grads.append({n: p.grad.detach().cpu() for n, p in m.named_parameters()
                      if "adapt" in n})
    assert np.isfinite(losses[0]) and losses[0] == pytest.approx(losses[1], rel=1e-4)
    for n, g in grads[1].items():
        err = float((grads[0][n] - g).abs().max())
        assert err <= 1e-3 * max(1.0, float(g.abs().max())), n


def _fused_chain_step(mesh, a, b, x, w) -> dict:
    """One forward and backward of the chain ``b(a(x))`` (a emits its raw output and its
    BN + ReLU as ``pre``) on this rank's rows, loss ``partial_mean(out * w)``: the
    gradients (summed over the mesh) and the running statistics, on the CPU."""
    from tdal_torch.parallel import mesh as pmesh

    before = dict(cv.launches)
    with pmesh.scope(mesh):
        y, pre = a(pmesh.rank_rows(x), emit_raw=True)
        out = b(y, pre=pre)
        pmesh.partial_mean(out * pmesh.rank_rows(w)).backward()
        if mesh is not None:
            pmesh.all_reduce_grads([*a.parameters(), *b.parameters()], mesh)
    torch.cuda.synchronize()
    named = {**{f"a.{k}": v for k, v in a.state_dict().items()},
             **{f"b.{k}": v for k, v in b.state_dict().items()}}
    grads = {**{f"a.{n}": p.grad for n, p in a.named_parameters()},
             **{f"b.{n}": p.grad for n, p in b.named_parameters()}}
    return dict(grads={k: g.double().cpu() for k, g in grads.items()},
                running={k: v.double().cpu() for k, v in named.items() if "running" in k},
                launches={k: cv.launches[k] - before[k] for k in before})


def _chain_rank(mesh, inputs, out_dir):
    """A spawned rank of ``test_fused_conv_bn_chain_data_parallel_on_card``."""
    from pathlib import Path

    a, b, x, w = (t.to(mesh.device) for t in torch.load(inputs, weights_only=False))
    torch.save(_fused_chain_step(mesh, a.train(), b.train(), x, w),
               Path(out_dir) / f"{mesh.rank}.pt")


@pytest.mark.gpu
def test_fused_conv_bn_chain_data_parallel_on_card(cuda, tmp_path):
    """Two gloo ranks on one card (NCCL refuses two ranks on one device) run a chained
    FusedConvBN pair on their halves of a batch of 4: K3's moments, all-reduced, give
    the global BN statistics and the chained ``pre``, and their cotangents, all-reduced
    in the backward, reach K7 and K5. The gradients (summed) and the running statistics
    must equal the single-process step's: gradients within max(8 x the change under a
    permutation of the batch, 1e-5 of the leaf's largest value), statistics rtol 1e-5."""
    import copy

    from tdal_torch.models.layers import FusedConvBN
    from tdal_torch.parallel import mesh as pmesh

    g = torch.Generator().manual_seed(0)
    a = FusedConvBN(16, 32, use_bias=True, momentum=0.1, eps=1e-5)
    b = FusedConvBN(32, 24)
    with torch.no_grad():
        for p in (*a.parameters(), *b.parameters()):
            noise = torch.randn(p.shape, generator=g)
            p.copy_(noise * 0.1 if p.dim() == 4 else 1.0 + 0.5 * noise)  # weights; affines
    x = torch.randn(4, 24, 20, 16, generator=g)
    w = torch.randn(4, 24, 20, 24, generator=g)
    torch.save((a, b, x, w), tmp_path / "inputs.pt")

    def single(perm):
        aa, bb = copy.deepcopy(a).to(cuda).train(), copy.deepcopy(b).to(cuda).train()
        return _fused_chain_step(None, aa, bb, x[perm].to(cuda), w[perm].to(cuda))

    want, permuted = single([0, 1, 2, 3]), single([2, 0, 3, 1])
    pmesh.spawn(_chain_rank, (str(tmp_path / "inputs.pt"), str(tmp_path)),
                devices=["cuda:0", "cuda:0"], backend="gloo")
    ranks = [torch.load(tmp_path / f"{r}.pt", weights_only=False) for r in range(2)]
    for got in ranks:
        launches = got["launches"]
        assert launches["conv3x3_fwd_stats"] == 2 and launches["conv3x3_dgrad_act"] == 1
        for k, v in want["grads"].items():
            floor = float((v - permuted["grads"][k]).abs().max())
            tol = max(8 * floor, 1e-5 * float(v.abs().max()) + 1e-7)
            err = float((got["grads"][k] - v).abs().max())
            assert err <= tol, f"grad {k}: {err:.3e} > {tol:.3e}"
        for k, v in want["running"].items():
            assert torch.allclose(got["running"][k], v, rtol=1e-5,
                                  atol=1e-6 * max(1.0, float(v.abs().max()))), k
    for k, v in ranks[0]["grads"].items():
        assert torch.equal(v, ranks[1]["grads"][k]), k


def _spatial_chain_rank(mesh, inputs, out_dir):
    """A spawned rank of ``test_fused_conv_bn_chain_spatial_on_card``: the chain on this
    rank's rows of the whole batch, the loss on the gathered output."""
    from pathlib import Path

    from tdal_torch.parallel import mesh as pmesh

    a, b, x, w = (t.to(mesh.device) for t in torch.load(inputs, weights_only=False))
    slab = pmesh.spatial_slab(mesh, x.shape[1])
    before, before_halo = dict(cv.launches), dict(cv.halo_launches)
    with pmesh.scope(mesh):
        y, pre = a.train()(slab.take(x), emit_raw=True, slab=slab)
        out = slab.gather(b.train()(y, pre=pre, slab=slab))
        (out * w).mean().backward()
        pmesh.all_reduce_grads([*a.parameters(), *b.parameters()], mesh)
    torch.cuda.synchronize()
    named = {**{f"a.{k}": v for k, v in a.state_dict().items()},
             **{f"b.{k}": v for k, v in b.state_dict().items()}}
    grads = {**{f"a.{n}": p.grad for n, p in a.named_parameters()},
             **{f"b.{n}": p.grad for n, p in b.named_parameters()}}
    torch.save(dict(grads={k: g.double().cpu() for k, g in grads.items()},
                    running={k: v.double().cpu() for k, v in named.items() if "running" in k},
                    launches={k: cv.launches[k] - before[k] for k in before},
                    halo={k: cv.halo_launches[k] - before_halo[k] for k in before}),
               Path(out_dir) / f"{mesh.rank}.pt")


@pytest.mark.gpu
def test_fused_conv_bn_chain_spatial_on_card(cuda, tmp_path):
    """BEV spatial partitioning on the card: two gloo ranks sharing it run a chained
    FusedConvBN pair on their row slabs (13 / 12 rows of 25) of the whole batch, K3, K7
    and K5 in the halo form (the first layer's input takes no gradient: no K4), the BN moments and counts all-reduced, the loss on the
    gathered output. The gradients (summed over the ranks) and the running statistics
    equal the single-process step's, as the data-parallel test holds them."""
    import copy

    from tdal_torch.models.layers import FusedConvBN
    from tdal_torch.parallel import mesh as pmesh

    g = torch.Generator().manual_seed(0)
    a = FusedConvBN(16, 32, use_bias=True, momentum=0.1, eps=1e-5)
    b = FusedConvBN(32, 24)
    with torch.no_grad():
        for p in (*a.parameters(), *b.parameters()):
            noise = torch.randn(p.shape, generator=g)
            p.copy_(noise * 0.1 if p.dim() == 4 else 1.0 + 0.5 * noise)
    x = torch.randn(2, 25, 20, 16, generator=g)
    w = torch.randn(2, 25, 20, 24, generator=g)
    torch.save((a, b, x, w), tmp_path / "inputs.pt")

    def single(perm):
        aa, bb = copy.deepcopy(a).to(cuda).train(), copy.deepcopy(b).to(cuda).train()
        y, pre = aa(x[perm].to(cuda), emit_raw=True)
        (bb(y, pre=pre) * w[perm].to(cuda)).mean().backward()
        torch.cuda.synchronize()
        named = {**{f"a.{k}": v for k, v in aa.state_dict().items()},
                 **{f"b.{k}": v for k, v in bb.state_dict().items()}}
        grads = {**{f"a.{n}": p.grad for n, p in aa.named_parameters()},
                 **{f"b.{n}": p.grad for n, p in bb.named_parameters()}}
        return dict(grads={k: v.double().cpu() for k, v in grads.items()},
                    running={k: v.double().cpu() for k, v in named.items() if "running" in k})

    want, permuted = single([0, 1]), single([1, 0])
    pmesh.spawn(_spatial_chain_rank, (str(tmp_path / "inputs.pt"), str(tmp_path)),
                devices=["cuda:0", "cuda:0"], backend="gloo", spatial=2)
    ranks = [torch.load(tmp_path / f"{r}.pt", weights_only=False) for r in range(2)]
    for got in ranks:
        assert got["launches"] == got["halo"] == {
            "conv3x3_fwd_stats": 2, "conv3x3_fwd": 0, "conv3x3_wgrad": 2,
            "conv3x3_dgrad_act": 1}
        for k, v in want["grads"].items():
            floor = float((v - permuted["grads"][k]).abs().max())
            tol = max(8 * floor, 1e-5 * float(v.abs().max()) + 1e-7)
            err = float((got["grads"][k] - v).abs().max())
            assert err <= tol, f"grad {k}: {err:.3e} > {tol:.3e}"
        for k, v in want["running"].items():
            assert torch.allclose(got["running"][k], v, rtol=1e-5,
                                  atol=1e-6 * max(1.0, float(v.abs().max()))), k
    for k, v in ranks[0]["grads"].items():
        assert torch.equal(v, ranks[1]["grads"][k]), k


@pytest.mark.gpu
def test_dist_test_spatial_shards_over_nccl(cuda, tmp_path, monkeypatch):
    """``dist_test --spatial_shards 2`` over NCCL on two cards writes the
    ``prediction.pkl`` of ``--spatial_shards 1`` on one card (pp_tiny, fresh weights,
    two synthetic frames; ``assert_same_detections``), with TF32 off in this process
    and, through ``NVIDIA_TF32_OVERRIDE``, in the spawned ranks: with it on, cuDNN's
    algorithms for a row slab and for the whole map differ by 1e-4 of the maps."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    monkeypatch.setenv("NVIDIA_TF32_OVERRIDE", "0")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    import pickle
    from pathlib import Path

    import numpy as np

    from tdal_torch.data.synthetic import make_synthetic_dataset
    from tdal_torch.models.builder import build_detector, build_voxel_config
    from tdal_torch.runtime.config import Config
    from tdal_torch.tools import dist_test

    root = Path(__file__).resolve().parent.parent
    cfg_path = root / "configs/synthetic/pp_tiny.py"
    make_synthetic_dataset(tmp_path / "val", n_scenes=1, n_frames=2, seed=2,
                           n_background=800, points_per_object=64)
    cfg = Config.fromfile(cfg_path)
    model = build_detector(cfg.model, build_voxel_config(cfg.voxel_generator), "cpu", 0)
    torch.save({"model": model.state_dict()}, tmp_path / "model.pt")
    out = {}
    for n in (1, 2):
        work = tmp_path / f"shards{n}"
        dist_test.main([str(cfg_path), "--checkpoint", str(tmp_path / "model.pt"),
                        "--info_path", str(tmp_path / "val" / "infos.pkl"), "--batch_size",
                        "2", "--work_dir", str(work), "--spatial_shards", str(n)])
        out[n] = pickle.loads((work / "prediction.pkl").read_bytes())
    assert "(nccl)" in (tmp_path / "shards2" / "test.log").read_text()
    assert out[1].keys() == out[2].keys() and len(out[1]) == 2
    for token, want in out[1].items():
        assert_same_detections(out[2][token], want, token)


def assert_same_detections(got, want, what, tol=1e-5):
    """One frame's detections (``predictions_to_host``'s dict) equal but for the order
    of near-tied scores and the knife edge of the post-NMS cut: every box of one side
    matches one of the other (label equal, score and box within ``tol`` of max(1, |x|)),
    but for boxes whose score lies within ``tol`` of the cut (the higher of the two
    sides' lowest kept scores). Fresh weights leave many scores tied to 1e-7, which
    the cuDNN convs of a row slab and of the whole map may order either way."""
    import numpy as np

    sg, sw = got["scores"], want["scores"]
    used, alone = np.zeros(len(sw), bool), []
    for i, score in enumerate(sg):
        near = (~used & (want["label_preds"] == got["label_preds"][i])
                & (np.abs(sw - score) <= tol * max(1.0, abs(score)))
                & (np.abs(want["box3d_lidar"] - got["box3d_lidar"][i])
                   <= tol * np.maximum(1.0, np.abs(got["box3d_lidar"][i]))).all(axis=1))
        hit = np.flatnonzero(near)
        if len(hit):
            used[hit[0]] = True
        else:
            alone.append(float(score))
    alone += [float(v) for v in sw[~used]]
    cut = max(float(sg.min(initial=np.inf)), float(sw.min(initial=np.inf)))
    assert all(v <= cut + tol for v in alone), (what, alone, cut)
    assert len(alone) <= max(2, len(sw) // 10), (what, len(alone))


@pytest.mark.gpu
def test_tdal_checkpoint_reads_and_serves_on_card(cuda):
    """``chip_smoke.py`` phase 13 at the fixture's size: tdal's checkpoint
    (``tests/data/tdal_ckpt``) read bit for bit in a process that cannot import jax,
    orbax, tensorstore, zstandard, zarr or numcodecs, then served on the card by
    ``dist_test`` with its head maps within ``MAP_TOL`` of tdal's recorded ones and its
    kept sets equal but for knife edges."""
    import chip_smoke

    out = chip_smoke.phase_tdal_checkpoint(cuda)
    assert sum(out["read"]["leaves"].values()) == 6 * 34
    assert max(out["serve"]["map_rel_err"].values()) <= chip_smoke.MAP_TOL
