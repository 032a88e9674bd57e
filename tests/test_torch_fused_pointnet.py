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


# ---------------------------------------------------------------------------
# The CUDA kernels' arithmetic emulated on the CPU (tdal_torch/ops/csrc/fused_pointnet.cu):
# their weight streams read back as the kernels address them, f32 operands as split
# TF32 (hi = the 13 low mantissa bits cleared, lo = a - hi, products lo*hi + hi*lo +
# hi*hi, each k-step of 8 added to the f32 accumulator of its output and truncated as
# the tensor cores truncate), bf16 operands rounded once and summed per k-step of 16.
# Each layer keeps one accumulator over its whole depth (64..512), as the kernels do;
# gproj (depth 1024) one per slice of 128.
# ---------------------------------------------------------------------------

# The kernels read k position p of a tf32 A fragment from this column of each group of
# 8 accumulator columns: the accumulator holds columns 2t and 2t+1 of a group, and the
# fragment takes positions t and t+4 from them
FRAG_COLUMN = tuple(2 * p if p < 4 else 2 * (p - 4) + 1 for p in range(8))


def _tf32(a):
    """f32 -> TF32 by clearing the 13 low mantissa bits: what the tensor core reads."""
    return (a.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _to_f32_toward_zero(d):
    f = d.float()
    return torch.where(f.double().abs() > d.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


class _Stream:
    """A packed weight stream, read slice by slice in the order a kernel consumes it."""

    def __init__(self, flat, bf16):
        self.flat, self.bf16, self.pos = flat.float(), bf16, 0

    def take(self, ks, n):
        """The next slice as (parts, ks, n) in the kernel's k order: (hi, lo) or (bf16,)."""
        e, parts = (8, 1) if self.bf16 else (4, 2)
        size = parts * ks * n
        t = self.flat[self.pos:self.pos + size].reshape(parts, n // 64, ks // e, 8, 8, e)
        self.pos += size
        # (part, tile, 16-byte column, row group, row, element) -> (part, k, n)
        return t.permute(0, 2, 5, 1, 3, 4).reshape(parts, ks, n)

    def done(self):
        return self.pos == self.flat.numel()


def _mma(acc, a, b, from_acc, bf16, one_pass=False):
    """acc + a @ b as a kernel's wgmmas: a (M, ks) activations in accumulator column
    order, b the stream's slice."""
    if from_acc and not bf16:
        k = a.shape[1]
        a = a[:, [8 * (i // 8) + FRAG_COLUMN[i % 8] for i in range(k)]]
    if bf16:
        terms, step = [(a.bfloat16().float(), b[0])], 16
    else:
        ah, bh = _tf32(a), _tf32(b[0])
        al, bl = _tf32(a - ah), _tf32(b[1])
        terms, step = ([(ah, bh)] if one_pass else [(al, bh), (ah, bl), (ah, bh)]), 8
    for k0 in range(0, a.shape[1], step):
        for x, y in terms:
            part = x[:, k0:k0 + step].double() @ y[k0:k0 + step].double()
            acc = _to_f32_toward_zero(acc.double() + part)
    return acc


def emulate_encoder(pts, enc_w, enc_b, bf16, one_pass=False):
    """K1 on one set pts (M, Cin): (skip (M, 64), gmax (1024,))."""
    s = _Stream(fp.weight_stream(False, enc_w, bf16), bf16)

    def layer(x, i, ks, n):
        acc = _mma(torch.zeros(x.shape[0], n), x, s.take(ks, n), True, bf16, one_pass)
        return torch.relu(acc + enc_b[i])

    h = torch.relu(fp._mm(pts, enc_w[0], bf16) + enc_b[0])  # the CUDA cores, f32 FMA
    skip = layer(h, 1, 64, 64)
    h = layer(layer(skip, 2, 64, 64), 3, 64, 128)
    out = []
    for j in range(8):  # 128 outputs at a time, over two slices of 64 inputs
        acc = torch.zeros(h.shape[0], 128)
        for half in range(2):
            acc = _mma(acc, h[:, 64 * half:64 * half + 64], s.take(64, 128), True, bf16,
                       one_pass)
        out.append(torch.relu(acc + enc_b[4][128 * j:128 * j + 128]))
    assert s.done()
    return skip, torch.cat(out, dim=1).amax(dim=0)


def emulate_gproj(gmax, s, bf16, one_pass=False):
    """K2's gproj kernel without its bias: gmax (B, 1024) @ W0[64:] by 64-output tile,
    each slice of 128 inputs into a zeroed accumulator joined to the total by an f32
    add."""
    out = []
    for _ in range(512 // 64):
        total = torch.zeros(gmax.shape[0], 64)
        for k0 in range(0, 1024, 128):
            total = total + _mma(torch.zeros(gmax.shape[0], 64), gmax[:, k0:k0 + 128],
                                 s.take(128, 64), False, bf16, one_pass)
        out.append(total)
    return torch.cat(out, dim=1)


def emulate_decoder(skip, gmax, dec_w, dec_b, lw, lb, bf16, one_pass=False):
    """K2 on one set: skip (M, 64), gmax (1024,) -> logits (M, 2)."""
    flat = fp.weight_stream(True, dec_w, bf16)
    s = _Stream(flat, bf16)
    m = skip.shape[0]
    # gproj's slices follow the point kernel's: read them with a reader of their own
    g = _Stream(flat, bf16)
    g.pos = flat.numel() - (2 if not bf16 else 1) * 1024 * 512
    gproj = emulate_gproj(gmax[None], g, bf16, one_pass)[0] + dec_b[0]
    h2 = torch.zeros(m, 256)
    for c in range(8):
        h1 = _mma(torch.zeros(m, 64), skip, s.take(64, 64), False, bf16, one_pass)
        h1 = torch.relu(h1 + gproj[64 * c:64 * c + 64])
        for half in range(2):
            h2 = _mma(h2, h1[:, 32 * half:32 * half + 32], s.take(32, 256), True, bf16, one_pass)
    h = torch.relu(h2 + dec_b[1])
    for i in (2, 3):
        acc = torch.zeros(m, 128)
        for j in range(h.shape[1] // 32):
            acc = _mma(acc, h[:, 32 * j:32 * j + 32], s.take(32, 128), True, bf16, one_pass)
        h = torch.relu(acc + dec_b[i])
    logits = fp._mm(h, lw, bf16) + lb  # the CUDA cores
    assert s.pos == g.pos - 1024 * 512 * (1 if bf16 else 2) and g.done()
    return logits


SKIP = fp.SKIP_CH


def _rel(got, ref):
    return float((got.double() - ref.double()).abs().max()) / max(1.0, float(ref.abs().max()))


def _chain_f64(pts, folded):
    """The labelers' PointNetSeg on folded weights in float64: (skip, gmax, logits)."""
    enc_w, enc_b, dec_w, dec_b, lw, lb = (
        [t.double() for t in x] if isinstance(x, list) else x.double() for x in folded)
    h, skip = pts.double(), None
    for i, (w, b) in enumerate(zip(enc_w, enc_b)):
        h = torch.relu(h @ w + b)
        skip = h if i == 1 else skip
    gmax = h.amax(dim=0)
    x = torch.relu(skip @ dec_w[0][:SKIP] + gmax @ dec_w[0][SKIP:] + dec_b[0])
    for w, b in zip(dec_w[1:], dec_b[1:]):
        x = torch.relu(x @ w + b)
    return skip, gmax, x @ lw + lb


def _emulation_case(cin, n=300):
    from tdal_torch.pipeline.factories import random_pointnet_seg

    pts = torch.from_numpy(np.random.default_rng(cin).normal(size=(n, cin)).astype(np.float32))
    with torch.inference_mode():
        folded = fp.fold_pointnet_seg_params(random_pointnet_seg(cin, seed=cin))
    return pts, folded


@pytest.mark.parametrize("cin", [3, 4])
def test_split_tf32_kernels_hold_the_f32_tolerance(cin):
    """K1 and K2 as the kernels compute them with f32 operands, over a few hundred points
    at the real widths (depths 64, 128 and 512): within 1e-5 of the f32 twin and of
    float64; the same chain with one-pass TF32 products is not."""
    pts, folded = _emulation_case(cin)
    enc_w, enc_b, dec = folded[0], folded[1], folded[2:]
    with torch.inference_mode():
        skip, gmax = emulate_encoder(pts, enc_w, enc_b, False)
        skip_t, gmax_t = fp.fused_seg_encoder_plain(pts[None], enc_w, enc_b)
        logits = emulate_decoder(skip_t[0], gmax_t[0], *dec, False)
        logits_t = fp.fused_seg_decoder_plain(skip_t, gmax_t, *dec)[0]
        skip64, gmax64, logits64 = _chain_f64(pts, folded)
        one_skip, one_gmax = emulate_encoder(pts, enc_w, enc_b, False, one_pass=True)
        one_logits = emulate_decoder(skip_t[0], gmax_t[0], *dec, False, one_pass=True)
    for got, twin, exact in ((skip, skip_t[0], skip64), (gmax, gmax_t[0], gmax64),
                             (logits, logits_t, logits64)):
        assert _rel(got, twin) <= F32_TOL
        assert _rel(got, exact) <= F32_TOL
    assert _rel(one_skip, skip64) > F32_TOL and _rel(one_gmax, gmax64) > F32_TOL
    assert _rel(one_logits, logits64) > _rel(logits, logits64)


@pytest.mark.parametrize("cin", [3, 4])
def test_bf16_kernels_match_the_bf16_twin(cin):
    """The same emulation with bf16 operands, against the bf16 twin at the card's bf16
    tolerance (2e-3 of max(1, |twin|): a summation-order difference can move an
    activation across a bf16 rounding step)."""
    pts, folded = _emulation_case(cin)
    enc_w, enc_b, dec = folded[0], folded[1], folded[2:]
    with torch.inference_mode():
        skip, gmax = emulate_encoder(pts, enc_w, enc_b, True)
        skip_t, gmax_t = fp.fused_seg_encoder_plain(pts[None], enc_w, enc_b, True)
        logits = emulate_decoder(skip_t[0], gmax_t[0], *dec, True)
        logits_t = fp.fused_seg_decoder_plain(skip_t, gmax_t, *dec, True)[0]
    assert _rel(skip, skip_t[0]) <= 2e-3
    assert _rel(gmax, gmax_t[0]) <= 2e-3
    assert _rel(logits, logits_t) <= 2e-3


@pytest.mark.parametrize("k", [64, 128, 512, 1024])
def test_split_tf32_accumulation_at_the_chain_depths(k):
    """One output accumulated over the point kernels' depths (64, 128, 512) and over
    gproj's 1024: ReLU'd N(0, 1) activations, N(0, 1/k) weights. Up to 512, 3xTF32 into
    one truncating accumulator stays within 1e-5 of float64 and of the f32 product (the
    point kernels' design); at 1024 it does not (1.06e-5 here), so there each K slice of
    128 sums into a zeroed accumulator joined to the total by a rounded f32 add, which
    holds (K2's gproj kernel). One-pass TF32 fails."""
    rng = np.random.default_rng(k)
    a = torch.relu(torch.from_numpy(rng.normal(size=(256, k)).astype(np.float32)))
    w = torch.from_numpy((rng.normal(size=(k, 64)) / np.sqrt(k)).astype(np.float32))
    hi = _tf32(w)
    exact = a.double() @ w.double()
    one_acc = _mma(torch.zeros(256, 64), a, (hi, w - hi), False, False)
    if k <= 512:
        got = one_acc
    else:
        assert _rel(one_acc, exact) > F32_TOL
        got = torch.zeros(256, 64)
        for k0 in range(0, k, 128):
            sl = slice(k0, k0 + 128)
            got = got + _mma(torch.zeros(256, 64), a[:, sl], (hi[sl], (w - hi)[sl]), False, False)
    one = _mma(torch.zeros(256, 64), a, (hi, w - hi), False, False, one_pass=True)
    assert _rel(got, exact) <= F32_TOL
    assert _rel(got, a @ w) <= F32_TOL
    assert _rel(one, exact) > F32_TOL


@pytest.mark.parametrize("bf16", [False, True])
def test_weight_streams_read_back_as_the_layers(bf16):
    """Each stream holds every weight once, in the kernel's order: read back slice by
    slice, f32 hi + lo equals the weight exactly (hi a TF32 value), bf16 is the weight
    rounded once; input rows fed from an accumulator come in fragment order (f32)."""
    _, folded = _emulation_case(3, n=1)
    enc_w, dec_w = folded[0], folded[2]

    def check(got, w, from_acc):
        if from_acc and not bf16:
            k = w.shape[0]
            w = w[[8 * (i // 8) + FRAG_COLUMN[i % 8] for i in range(k)]]
        if bf16:
            assert torch.equal(got[0], w.bfloat16().float())
        else:
            assert torch.equal(got[0], _tf32(got[0]))
            assert torch.equal(got[0] + got[1], w)

    s = _Stream(fp.weight_stream(False, enc_w, bf16), bf16)
    for w in enc_w[1:4]:
        check(s.take(*w.shape), w, True)
    for j in range(8):
        for half in range(2):
            check(s.take(64, 128), enc_w[4][64 * half:64 * half + 64, 128 * j:128 * j + 128],
                  True)
    assert s.done()
    s = _Stream(fp.weight_stream(True, dec_w, bf16), bf16)
    for c in range(8):
        check(s.take(64, 64), dec_w[0][:SKIP, 64 * c:64 * c + 64], False)
        for half in range(2):
            r = 64 * c + 32 * half
            check(s.take(32, 256), dec_w[1][r:r + 32], True)
    for w in dec_w[2:4]:
        for j in range(w.shape[0] // 32):
            check(s.take(32, 128), w[32 * j:32 * j + 32], True)
    for c in range(8):
        for j in range(8):
            rows = slice(SKIP + 128 * j, SKIP + 128 * j + 128)
            check(s.take(128, 64), dec_w[0][rows, 64 * c:64 * c + 64], False)
    assert s.done()


def test_pointnet_seg_packs_once_per_weight_state():
    """``PointNetSeg.packed`` folds and packs once per state of the weights: the same
    objects while nothing changed; anew after an in-place write, a load or a move; and
    on every call for weights made under inference mode. What it returns is always
    the fold and the streams of the weights as they are."""
    _, params, bs, model = _seg(3, 64, seed=5)

    def assert_current(packed):
        folded, streams = packed
        want = fp.fold_pointnet_seg_params(model)
        for got, ref in zip(jax.tree_util.tree_leaves(folded), jax.tree_util.tree_leaves(want)):
            assert torch.equal(got, ref)
        for got, ref in zip(streams, fp.seg_weight_streams(want)):
            assert torch.equal(got, ref)

    first = model.packed()
    assert_current(first)
    again = model.packed()
    assert again[1][0] is first[1][0] and again[1][1] is first[1][1]
    with torch.no_grad():
        model.dec.bn[0].running_var.mul_(2.0)
    written = model.packed()
    assert written[1][1] is not first[1][1]
    assert_current(written)
    model.load_state_dict(load_flax(PointNetSeg(3), params, bs).state_dict())
    loaded = model.packed()
    assert loaded[1][1] is not written[1][1]
    assert_current(loaded)
    model.to(torch.float64).to(torch.float32)
    moved = model.packed()
    assert moved[1][0] is not loaded[1][0]
    assert_current(moved)
    with torch.inference_mode():
        fresh = load_flax(PointNetSeg(3), params, bs).eval()
    assert fresh.packed()[1][0] is not fresh.packed()[1][0]
