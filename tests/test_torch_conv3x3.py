"""The 3x3 conv ops of the port (plain twins of K3, K4, K5/K6, K7 on the CPU) against
``tdal.ops.pallas_conv``, whose CPU route is its XLA reference (the route
``tests/test_pallas_conv.py`` runs).

Inputs come from seeded numpy and go through both packages. Tolerances (f32):
- forward y and moments: rtol 1e-5, atol 1e-5 x max(1, max |ref|): the same f32
  products summed in another order (XLA's conv against 9 shifted matmuls);
- gradients: rtol 1e-5, atol 1e-4 x (max |ref| + 1), the tolerance tdal's own custom
  VJP test uses against autodiff (``test_pallas_conv.py:145-149``), since the
  moment cotangent 2 y gss makes the backward's sums large.
- K7's twin in bf16: within one bf16 step of its f32 arithmetic rounded once, and
  equal to it on all but a few elements (below).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tdal.ops import pallas_conv as pc
from tdal_torch.ops import conv3x3 as cv

torch.set_num_threads(2)


def _inputs(seed, b, h, w, c, co, positive_shift=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    wt = (rng.normal(size=(3, 3, c, co)) / np.sqrt(9 * c)).astype(np.float32)
    bias = rng.normal(size=(co,)).astype(np.float32)
    s = rng.uniform(0.5, 2.0, c).astype(np.float32)
    t = (np.abs(rng.normal(size=c)) + 0.5 if positive_shift
         else rng.normal(size=c)).astype(np.float32)
    # cotangent weights of a loss on y and on the two moments
    wy = rng.normal(size=(b, h, w, co)).astype(np.float32)
    ws = rng.normal(size=(2, co)).astype(np.float32) * 0.1
    return x, wt, bias, s, t, wy, ws


def _close(got, want, rtol, atol_scale):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol_scale * (float(np.abs(want).max()) + 1.0))


# (B, H, W, C, Co, positive shifts): tdal's VJP test shape, and a ragged image with
# positive shifts, where a halo that leaked relu(t) would move every border output
CASES = [(2, 8, 9, 5, 7, False), (1, 13, 11, 4, 6, True)]


@pytest.mark.parametrize("in_act", [False, True])
@pytest.mark.parametrize("case", CASES, ids=["tdal-vjp-shape", "ragged-halo"])
def test_conv3x3_act_stats_matches_tdal(case, in_act):
    *shape, pos = case
    x, w, b, s, t, wy, ws = _inputs(0, *shape, positive_shift=pos)

    y_ref, st_ref = pc.conv3x3_act_stats(*map(jnp.asarray, (x, w, b, s, t)), in_act)
    y, st = cv.conv3x3_act_stats(*map(torch.from_numpy, (x, w, b, s, t)), in_act)
    _close(y.numpy(), y_ref, 1e-5, 1e-5)
    _close(st.numpy(), st_ref, 1e-5, 1e-5)

    def loss_ref(*a):
        yy, ss = pc.conv3x3_act_stats(*a, in_act)
        return (yy * wy).sum() + (ss * ws).sum()

    g_ref = jax.grad(loss_ref, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (x, w, b, s, t)))
    args = [torch.tensor(a, requires_grad=True) for a in (x, w, b, s, t)]
    yy, ss = cv.conv3x3_act_stats(*args, in_act)
    ((yy * torch.from_numpy(wy)).sum() + (ss * torch.from_numpy(ws)).sum()).backward()
    for name, a, want in zip("x w bias in_scale in_shift".split(), args, g_ref):
        assert a.grad is not None, name
        _close(a.grad.numpy(), want, 1e-5, 1e-4)


def test_in_act_halo_stays_zero():
    """Positive shifts on a ragged image: the border outputs see relu(x*s+t) padded
    with zeros, i.e. exactly conv_bias of the materialised activation."""
    x, w, b, s, t, _, _ = _inputs(1, 1, 13, 11, 4, 6, positive_shift=True)
    xt, wt, bt, st_, tt = map(torch.from_numpy, (x, w, b, s, t))
    y, stats = cv.conv3x3_act_stats(xt, wt, bt, st_, tt, True)
    act = torch.relu(xt * st_ + tt)
    y_mat, stats_mat = cv.conv3x3_act_stats(act, wt, bt, torch.ones(4), torch.zeros(4), False)
    _close(y.numpy(), y_mat.numpy(), 1e-6, 1e-6)
    _close(stats.numpy(), stats_mat.numpy(), 1e-6, 1e-6)
    # and against tdal's materialised reference
    y_ref = pc._xla_conv(jnp.asarray(np.maximum(x * s + t, 0)), jnp.asarray(w)) + b
    _close(y.numpy(), y_ref, 1e-5, 1e-5)


@pytest.mark.parametrize("op", ["conv3x3_bias", "conv3x3"])
def test_conv3x3_bias_matches_tdal(op):
    x, w, b, _, _, wy, _ = _inputs(2, 2, 9, 12, 6, 5)
    if op == "conv3x3":
        ref = lambda xx, ww, bb: pc.conv3x3(xx, ww)  # noqa: E731
        port = lambda xx, ww, bb: cv.conv3x3(xx, ww)  # noqa: E731
    else:
        ref, port = pc.conv3x3_bias, cv.conv3x3_bias
    y_ref = ref(*map(jnp.asarray, (x, w, b)))
    args = [torch.tensor(a, requires_grad=True) for a in (x, w, b)]
    y = port(*args)
    _close(y.detach().numpy(), y_ref, 1e-5, 1e-5)
    g_ref = jax.grad(lambda *a: (ref(*a) * wy).sum(), argnums=(0, 1, 2))(
        *map(jnp.asarray, (x, w, b)))
    (y * torch.from_numpy(wy)).sum().backward()
    n = 3 if op == "conv3x3_bias" else 2  # conv3x3's zero bias takes no gradient
    for a, want in list(zip(args, g_ref))[:n]:
        _close(a.grad.numpy(), want, 1e-5, 1e-4)


@pytest.mark.parametrize("relu", [False, True])
def test_conv3x3_affine_matches_tdal(relu):
    x, w, b, _, _, _, _ = _inputs(3, 2, 10, 7, 5, 8)
    scale = np.linspace(0.5, 1.5, 8).astype(np.float32)
    y_ref = pc.conv3x3_affine(*map(jnp.asarray, (x, w, scale, b)), relu=relu)
    y = cv.conv3x3_affine(*map(torch.from_numpy, (x, w, scale, b)), relu=relu)
    _close(y.numpy(), y_ref, 1e-5, 1e-5)


@pytest.mark.parametrize("case", CASES, ids=["tdal-vjp-shape", "ragged-halo"])
def test_dgrad_act_twin_and_backward_match_tdal_vjp(case):
    """K7's twin, and the CPU backward of ``conv3x3_act_stats`` with ``in_act``, against
    ``jax.vjp`` of tdal's op (its XLA ``_cas_bwd``, the same function) for dx, ds and
    dt, with shifts of both signs so the ReLU mask varies. The cotangent of the moments
    is 0, so the conv's cotangent is gy itself."""
    *shape, _ = case
    x, w, b, s, _, gy, _ = _inputs(9, *shape)
    t = np.random.default_rng(10).normal(size=shape[3]).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: pc.conv3x3_act_stats(*a, True),
                     *map(jnp.asarray, (x, w, b, s, t)))
    dx_ref, _, _, ds_ref, dt_ref = vjp((jnp.asarray(gy), jnp.zeros((2, shape[4]))))
    mask = x * s + t > 0
    assert 0.2 < mask.mean() < 0.8

    dx, st = cv.conv3x3_dgrad_act_plain(*map(torch.from_numpy, (gy, np.asarray(
        cv._flip_swap(torch.from_numpy(w))), x, s, t)))
    for got, want in ((dx, dx_ref), (st[0], ds_ref), (st[1], dt_ref)):
        _close(got.numpy(), want, 1e-5, 1e-4)

    args = [torch.tensor(a, requires_grad=True) for a in (x, w, b, s, t)]
    y, stats = cv.conv3x3_act_stats(*args, True)
    torch.autograd.backward([y, stats], [torch.from_numpy(gy), torch.zeros(2, shape[4])])
    for a, want in zip((args[0], args[3], args[4]), (dx_ref, ds_ref, dt_ref)):
        _close(a.grad.numpy(), want, 1e-5, 1e-4)


def test_dgrad_act_twin_rounds_once_in_bf16():
    """In bf16, K7's twin rounds dx once: dxh * s of the f32 accumulator, then bf16 (the
    fused kernel's arithmetic; ``tdal``'s Pallas K7 rounds once too). Against that
    value computed in float64 from the same bf16 operands it differs by at most one
    bf16 step and on under 1% of elements (where the f32 and float64 sums fall on two
    sides of a rounding boundary). tdal's XLA route, which rounds dxhat to bf16 before
    the mask, differs on far more: so this pins the single rounding."""
    x, w, _, s, _, gy, _ = _inputs(11, 2, 12, 13, 16, 24)
    t = np.random.default_rng(12).normal(size=16).astype(np.float32)
    gyb, wb, xb = (torch.from_numpy(a).bfloat16() for a in (gy, w, x))
    wt = cv._flip_swap(wb)
    dx, _ = cv.conv3x3_dgrad_act_plain(gyb, wt, xb, torch.from_numpy(s), torch.from_numpy(t))
    assert dx.dtype == torch.bfloat16

    acc = np.asarray(pc._xla_conv(jnp.asarray(gyb.double().numpy()),
                                  jnp.asarray(wt.double().numpy())), np.float64)
    xf = xb.float().numpy()
    once = torch.from_numpy(acc * (xf * s + t > 0) * s).bfloat16().double().numpy()
    got = dx.double().numpy()
    step = 2.0**-7 * np.abs(once)  # one bf16 step at each value (8 significant bits)
    assert (np.abs(got - once) <= step + 1e-30).all()
    assert (got != once).mean() < 0.01

    _, vjp = jax.vjp(lambda *a: pc.conv3x3_act_stats(*a, True),
                     *(jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) for a in (xb, wb)),
                     jnp.zeros(24), jnp.asarray(s), jnp.asarray(t))
    dx_xla = np.asarray(vjp((jnp.asarray(gyb.float().numpy()).astype(jnp.bfloat16),
                             jnp.zeros((2, 24))))[0], np.float64)
    assert (dx_xla != once).mean() > 0.05  # 14% of the elements (half are masked)


def test_wgrad_twin_is_the_correlation_of_tdal():
    """K5/K6's twin against tdal's XLA wgrad (the lhs/rhs-transposed correlation of
    ``_cas_bwd``) on the activated input."""
    x, _, _, s, t, _, _ = _inputs(4, 2, 7, 10, 3, 4, positive_shift=True)
    gy = np.random.default_rng(5).normal(size=(2, 7, 10, 4)).astype(np.float32)
    for in_act in (False, True):
        xin = np.maximum(x * s + t, 0) if in_act else x
        ref = jax.lax.conv_general_dilated(
            jnp.asarray(xin).transpose(3, 1, 2, 0), jnp.asarray(gy).transpose(1, 2, 0, 3),
            (1, 1), [(1, 1), (1, 1)], dimension_numbers=("NHWC", "HWIO", "NHWC"),
        ).transpose(1, 2, 0, 3)
        got = cv.conv3x3_wgrad(*map(torch.from_numpy, (x, gy, s, t)), in_act)
        _close(got.numpy(), ref, 1e-5, 1e-5)


def test_bf16_twin_rounds_like_the_tpu_kernel():
    """bf16: the activated input is rounded to bf16 before the taps and the moments
    come from the f32 accumulator (the TPU kernel), so the twin's y is within one
    bf16 step (2^-8 relative) of tdal's f32 result on the same bf16-rounded operands,
    and its moments match the f32 moments of that accumulator to 1e-5."""
    x, w, b, s, t, _, _ = _inputs(6, 1, 9, 9, 8, 8)
    xb = torch.from_numpy(x).bfloat16()
    wb = torch.from_numpy(w).bfloat16()
    y, st = cv.conv3x3_act_stats(xb, wb, *map(torch.from_numpy, (b, s, t)), True)
    assert y.dtype == torch.bfloat16
    act = torch.relu(xb.float() * torch.from_numpy(s) + torch.from_numpy(t))
    act = act.bfloat16().float().numpy()
    y_ref = np.asarray(pc._xla_conv(jnp.asarray(act), jnp.asarray(wb.float().numpy()))) + b
    np.testing.assert_allclose(y.float().numpy(), y_ref, rtol=2.0**-8, atol=1e-5)
    st_ref = np.stack([y_ref.sum((0, 1, 2)), (y_ref * y_ref).sum((0, 1, 2))])
    _close(st.numpy(), st_ref, 1e-5, 1e-5)


def test_wrappers_take_the_twin_on_the_cpu_only():
    """CPU tensors run the twins and count no launch; the launch counters move only
    on the card (tests/test_torch_kernels_gpu.py)."""
    before = dict(cv.launches)
    x, w, b, s, t, _, _ = _inputs(7, 1, 5, 6, 3, 4)
    cv.conv3x3_fwd_stats(*map(torch.from_numpy, (x, w, b, s, t)), True)
    cv.conv3x3_fwd(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    cv.conv3x3_wgrad(torch.from_numpy(x), torch.zeros(1, 5, 6, 4), torch.from_numpy(s),
                     torch.from_numpy(t), False)
    cv.conv3x3_dgrad_act(torch.zeros(1, 5, 6, 4), cv._flip_swap(torch.from_numpy(w)),
                         *map(torch.from_numpy, (x, s, t)))
    assert cv.launches == before


def test_conv3x3_module_matches_pallas_conv3x3():
    """``Conv3x3`` (the port of ``PallasConv3x3``) with tdal's flax init converted
    HWIO -> OIHW: forward and the gradients of input, kernel and bias."""
    from tdal.models.layers import PallasConv3x3
    from tdal_torch.models.layers import Conv3x3

    x, _, _, _, _, wy, _ = _inputs(8, 2, 6, 9, 5, 7)
    ref = PallasConv3x3(7, use_bias=True)
    params = ref.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = {"kernel": params["kernel"], "bias": jnp.linspace(-1.0, 1.0, 7)}
    mod = Conv3x3(5, 7, use_bias=True)
    mod.load_state_dict({"weight": torch.from_numpy(np.array(params["kernel"])).permute(3, 2, 0, 1),
                         "bias": torch.from_numpy(np.array(params["bias"]))})

    def loss_ref(p, xx):
        return (ref.apply({"params": p}, xx) * wy).sum()

    _close(mod(torch.from_numpy(x)).detach().numpy(),
           ref.apply({"params": params}, jnp.asarray(x)), 1e-5, 1e-5)
    gp, gx = jax.grad(loss_ref, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    (mod(xt) * torch.from_numpy(wy)).sum().backward()
    _close(xt.grad.numpy(), gx, 1e-5, 1e-4)
    _close(mod.weight.grad.permute(2, 3, 1, 0).numpy(), gp["kernel"], 1e-5, 1e-4)
    _close(mod.bias.grad.numpy(), gp["bias"], 1e-5, 1e-4)


# ---------------------------------------------------------------------------
# Split TF32 ("3xTF32"), the f32 products of the CUDA kernels, emulated on the CPU
# ---------------------------------------------------------------------------

CONV_TOL_F32 = 1e-5  # the f32 tolerance that holds the kernels to their twins on the card


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 explicit mantissa bits), ties away from zero,
    as ``cvt.rna.tf32.f32``: add half of the 13 dropped bits to the magnitude, then
    clear them."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_truncated(a: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 by clearing the 13 low mantissa bits (toward zero): the kernels'
    split, and what the tensor core reads of an f32 operand."""
    return (a.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


# hi = tf32(a), lo = tf32(a - hi): rounded to nearest, and as the kernels split (hi
# truncated, the exact remainder read by the tensor core as a truncated TF32)
SPLITS = {"rna": _tf32, "truncate": _tf32_truncated}


def _mm_3xtf32(a, b, split):
    """a @ b with each operand split hi + lo and the products hi*hi + hi*lo + lo*hi, in
    f32 (a product of two TF32 values is exact in f32)."""
    tf32 = SPLITS[split]
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return ah @ bl + al @ bh + ah @ bh


def _rel(got, ref):
    return float((got.double() - ref).abs().max()) / max(1.0, float(ref.abs().max()))


@pytest.mark.parametrize("split", list(SPLITS))
@pytest.mark.parametrize("c", [64, 128, 256, 384])
def test_split_tf32_holds_the_f32_tolerance_on_conv_sums(c, split):
    """The conv's dot products (K3/K4/K7: 9*C terms, x ~ N(0, 1), w ~ N(0, 1/(9C))):
    3xTF32 stays within the f32 tolerance of the float64 value and of the f32 product,
    and one-pass TF32 (the control) does not."""
    rng = np.random.default_rng(c)
    x = torch.from_numpy(rng.normal(size=(256, 9 * c)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(9 * c, 64)) / (3 * np.sqrt(c))).astype(np.float32))
    ref = x.double() @ w.double()
    got = _mm_3xtf32(x, w, split)
    assert _rel(got, ref) <= CONV_TOL_F32
    assert _rel(got, (x @ w).double()) <= CONV_TOL_F32
    assert _rel(_tf32(x) @ _tf32(w), ref) > CONV_TOL_F32


@pytest.mark.parametrize("split", list(SPLITS))
def test_split_tf32_holds_the_f32_tolerance_on_a_wgrad(split):
    """The wgrad's dot products over 2 x 224 x 224 = 100352 pixels (K5/K6 on the
    activated input): the same three checks against the f32 twin and float64."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 224, 224, 4)).astype(np.float32)
    gy = torch.from_numpy(rng.normal(size=(2, 224, 224, 8)).astype(np.float32))
    s = torch.from_numpy(rng.uniform(0.5, 2.0, 4).astype(np.float32))
    t = torch.from_numpy(rng.normal(size=4).astype(np.float32))
    act = cv._activate(torch.from_numpy(x), s, t, True)
    g = gy.reshape(-1, 8)
    taps = [tap.reshape(-1, 4).t().contiguous() for tap in cv._taps(act)]
    ref = torch.stack([tap.double() @ g.double() for tap in taps])
    got = torch.stack([_mm_3xtf32(tap, g, split) for tap in taps])
    twin = cv.conv3x3_wgrad_plain(torch.from_numpy(x), gy, s, t, True).reshape(9, 4, 8)
    assert _rel(got, ref) <= CONV_TOL_F32
    assert _rel(got, twin.double()) <= CONV_TOL_F32
    assert _rel(torch.stack([_tf32(tap) @ _tf32(g) for tap in taps]), ref) > CONV_TOL_F32
