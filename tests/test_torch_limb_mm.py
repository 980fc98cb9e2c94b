"""K5, the bf16-limb product of the precision names "high" and "default"
(evcouplings_torch/kernels/limb_mm.py), on the host: its plain version
against a float64 emulation of the limb passes and against the JAX
package's own products at those names (jnp.dot with the precision pairs
of evcouplings_tpu/ops/plm._precision; XLA-CPU forms them in exact
float32), in every form the fits take (the gradient added in place, the
stored limbs of the two-phase layouts, the logits from J_aug and from
J^T), at ragged shapes; the arguments the wrapper hands the CUDA kernel,
replayed by a numpy model of the kernel's indexing; and the wrapper's
refusals. The kernel itself runs on the card (tests/test_torch_gpu.py,
chip_smoke.py phase 3c)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evcouplings_tpu.ops import plm as jp
from evcouplings_torch.kernels import limb_mm as K
from evcouplings_torch.ops import plm as tp

EPS32 = 2.0 ** -24
# relative error of the limb split: one bf16 limb (round to nearest
# even, 8-bit significand) and two
LIMB_REL = {1: 2.0 ** -8, 2: 2.0 ** -17}
Q = 21


def _f32(rng, shape, scale=0.1):
    # several binades, and exact zeros
    x = rng.normal(size=shape) * scale * np.exp2(rng.integers(-6, 6, shape))
    x[rng.random(shape) < 0.05] = 0.0
    return x.astype(np.float32)


def _one_hot(rng, n, L, width):
    """(n, width) [one-hot | 1 | 0] of random codes with gaps (-1); the
    ones column where width > L q."""
    codes = rng.integers(-1, Q, size=(n, L))
    oh = np.zeros((n, width), np.float32)
    rows, sites = np.nonzero(codes >= 0)
    oh[rows, sites * Q + codes[rows, sites]] = 1.0
    if width > L * Q:
        oh[:, L * Q] = 1.0
    return oh


def _limbs_np(x, n):
    """The limbs of split_limbs in float64: bf16 rounding (to nearest
    even) of what the limbs before leave."""
    out, rest = [], torch.as_tensor(x)
    for _ in range(n):
        limb = rest.to(torch.bfloat16)
        out.append(limb.double().numpy())
        rest = rest - limb
    return out


def _case(form, L, B, seed):
    """One product of the fits: (limb side as the port lays it out, a
    float32 tensor; the exact side and out (or None) as numpy float32;
    the depth). The product is limb @ exact, or exact @ limb for the
    logits forms (out is None there)."""
    rng = np.random.default_rng(seed)
    lq = L * Q
    lq_aug = tp._augmented_width(lq)

    def t(x):
        return torch.from_numpy(x)

    if form == "grad":          # dJh += split(r^T) @ [oh | 1 | 0]
        return (t(_f32(rng, (B, lq))).T, _one_hot(rng, B, L, lq_aug),
                _f32(rng, (lq, lq_aug), 1.0), B)
    if form == "stored":        # two-phase: stored limbs of r^T @ oh_all
        return (t(_f32(rng, (3 * B, lq))).T,
                _one_hot(rng, 3 * B, L, lq_aug), None, 3 * B)
    if form == "sites_grad":    # per-site fit: dJ += split(r^T) @ oh
        return (t(_f32(rng, (B, lq))).T, _one_hot(rng, B, L, lq),
                _f32(rng, (lq, lq), 1.0), B)
    if form == "logits":        # [oh | 1 | 0] @ split(J_aug)
        return (t(_f32(rng, (lq_aug, lq), 0.05)),
                _one_hot(rng, B, L, lq_aug), None, lq_aug)
    assert form == "logits_t"   # oh @ split(J^T)
    return (t(_f32(rng, (lq, lq), 0.05)).T, _one_hot(rng, B, L, lq), None,
            lq)


FORMS = ("grad", "stored", "sites_grad", "logits", "logits_t")
SHAPES = [(9, 40), (7, 13)]     # (L, block rows); L=7: Lq 147, ragged


def _operands(form, limb, exact, out, n):
    """The torch operands the port hands limb_mm for a case."""
    if form == "stored":
        side = tuple(x.T for x in K.split_limbs(limb.T.contiguous(), n))
    else:
        side = K.Split(limb, n)
    e = torch.from_numpy(exact).to(torch.bfloat16)
    o = None if out is None else torch.from_numpy(out.copy())
    return side, e, o


def _call(fn, form, side, e, o):
    return fn(e, side, o) if form.startswith("logits") else fn(side, e, o)


@pytest.mark.parametrize("L,B", SHAPES)
@pytest.mark.parametrize("limbs", [1, 2])
@pytest.mark.parametrize("form", FORMS)
def test_plain_matches_float64_emulation_of_limb_passes(form, limbs, L, B):
    """The plain version on CPU tensors against the float64 sum of the
    same limb products: within float32 accumulation, (depth + limbs)
    2^-24 of sum |limb| |exact| (plus |out|), and `out` updated in place
    (the same tensor returned) where it is given."""
    limb, exact, out, depth = _case(form, L, B, seed=limbs + 10 * L)
    side, e, o = _operands(form, limb, exact, out, limbs)
    got = _call(K.limb_mm, form, side, e, o)
    if o is not None:
        assert got is o
    parts = _limbs_np(limb.contiguous(), limbs)
    ex = exact.astype(np.float64)
    if form.startswith("logits"):
        terms = [ex @ p for p in parts]
        absolute = ex @ sum(np.abs(p) for p in parts)
    else:
        terms = [p @ ex for p in parts]
        absolute = sum(np.abs(p) for p in parts) @ ex
    want = sum(terms)
    if out is not None:
        want = want + out
        absolute = absolute + np.abs(out)
    assert got.dtype == torch.float32
    assert got.shape == want.shape
    bound = (depth + limbs) * EPS32 * absolute
    assert np.all(np.abs(got.numpy() - want) <= bound)


@pytest.mark.parametrize("L,B", SHAPES)
@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("form", FORMS)
def test_plain_matches_jax_product_at_precision(form, precision, L, B):
    """The plain version against the JAX package's product at the same
    precision name (jnp.dot with its _precision pair: the one-hot exact,
    the float32 operand at HIGH or DEFAULT), which XLA-CPU forms in exact
    float32: within the limbs' 2^-17 (2 limbs) or 2^-8 (1 limb) of sum
    |a| |b|, plus float32 accumulation on both sides."""
    limbs = {"high": 2, "default": 1}[precision]
    limb, exact, out, depth = _case(form, L, B, seed=limbs + 10 * L + 1)
    side, e, o = _operands(form, limb, exact, out, limbs)
    got = _call(K.limb_mm, form, side, e, o).numpy().astype(np.float64)
    prec = jp._precision(precision)
    a = limb.contiguous().numpy()
    if form.startswith("logits"):
        want = jnp.dot(jnp.asarray(exact), jnp.asarray(a),
                       precision=prec.exact_lhs)
        absolute = exact.astype(np.float64) @ np.abs(a.astype(np.float64))
    else:
        want = jnp.dot(jnp.asarray(a), jnp.asarray(exact),
                       precision=prec.exact_rhs)
        absolute = np.abs(a.astype(np.float64)) @ exact.astype(np.float64)
    want = np.asarray(want, np.float64)
    if out is not None:
        want = want + out
        absolute = absolute + np.abs(out)
    bound = (LIMB_REL[limbs] + 2 * (depth + limbs) * EPS32) * absolute
    assert np.all(np.abs(got - want) <= bound)


def test_accumulate_adds_in_place_and_fresh_output_is_new():
    limb, exact, out, _ = _case("grad", 9, 40, seed=3)
    side, e, o = _operands("grad", limb, exact, out, 2)
    before = o.clone()
    fresh = K.limb_mm(side, e)
    got = K.limb_mm(side, e, o)
    assert got is o and got.data_ptr() == o.data_ptr()
    torch.testing.assert_close(got, before + fresh, rtol=0, atol=1e-6)
    # the plain version's arithmetic: out + (the passes' float32 sum)
    assert torch.equal(K.limb_mm_plain(side, e, before.clone()),
                       before + fresh)


def test_ops_plm_mm_routes_limb_sides_to_limb_mm(monkeypatch):
    """ops/plm._mm: a limb side goes to limb_mm, with `into` as its
    output; without limbs the product is _mm_acc, added into `into`."""
    seen = []
    real = K.limb_mm

    def spy(a, b, out=None):
        seen.append((type(a).__name__, type(b).__name__, out is not None))
        return real(a, b, out)

    monkeypatch.setattr(tp, "limb_mm", spy)
    rng = np.random.default_rng(4)
    r = torch.from_numpy(_f32(rng, (16, 27)))
    oh = torch.from_numpy(_one_hot(rng, 16, 1, 27)[:, :27])
    into = torch.zeros(27, 27)
    got = tp._mm(K.Split(r.T, 2), oh, torch.float32, into=into)
    assert got is into and seen == [("Split", "Tensor", True)]
    plain = torch.zeros(27, 27)
    assert tp._mm(r.T, oh, torch.float32, into=plain) is plain
    torch.testing.assert_close(plain, r.T @ oh)
    assert len(seen) == 1
    # _limb_operand takes the float32 operand as a Split where the
    # product takes limbs, and as itself elsewhere
    monkeypatch.setattr(tp, "_takes_limbs", lambda d, n, dev: True)
    assert isinstance(tp._limb_operand(r, 2), K.Split)
    assert isinstance(tp._transpose(tp._limb_operand(r, 2)), K.Split)
    assert tp._transpose(tp._limb_operand(r, 2)).x.stride() == (1, 27)


def _kernel_model(form, limbs, a0, a1, b, c, M, N, K_, lda, ldb, ldc,
                  accumulate):
    """numpy model of csrc/limb_mm.cu's indexing (evc_limb_mm's contract)
    over the flat storage of CPU tensors: forms 0/1 c[m ldc + n] (+)=
    sum_l A_l[m][k] b[k ldb + n] with A[m][k] = a[k lda + m]; forms 2/3
    c[n ldc + m] (+)= ... b[n ldb + k], A[m][k] = a[k lda + m] (form 2) or
    a[m lda + k] (form 3). Returns c's flat storage after the launch."""
    def storage(t):
        base = torch.empty(0, dtype=t.dtype).set_(t.untyped_storage())
        return base.double().numpy()[t.storage_offset():]

    m = np.arange(M)[:, None, None]
    n = np.arange(N)[None, :, None]
    k = np.arange(K_)[None, None, :]
    if form == K.FORM_STORED:
        A = [storage(t)[k * lda + m] for t in (a0, a1)[:limbs]]
    else:
        x = storage(a0)
        A0 = x[m * lda + k] if form == K.FORM_LOGITS_MK else x[k * lda + m]
        A = _limbs_np(A0.astype(np.float32), limbs)
    bs = storage(b)
    Bv = bs[k * ldb + n] if form in (K.FORM_GRAD, K.FORM_STORED) \
        else bs[n * ldb + k]
    prod = sum((Al * Bv).sum(axis=2) for Al in A)
    cs = storage(c).copy()
    idx = (m[:, :, 0] * ldc + n[:, :, 0] if form in (K.FORM_GRAD,
                                                       K.FORM_STORED)
           else n[:, :, 0] * ldc + m[:, :, 0])
    cs[idx] = (cs[idx] if accumulate else 0.0) + prod
    return cs


@pytest.mark.parametrize("L,B", SHAPES)
@pytest.mark.parametrize("limbs", [1, 2])
@pytest.mark.parametrize("form", FORMS)
def test_kernel_arguments_replay_the_product(form, limbs, L, B):
    """The form, pointers, extents, row pitches and flags the wrapper
    hands evc_limb_mm, read back through a numpy model of the kernel's
    indexing, give the plain version's product: the wrapper's layout
    mapping is the kernel's contract for every form the fits take."""
    limb, exact, out, _ = _case(form, L, B, seed=limbs + 10 * L + 2)
    side, e, o = _operands(form, limb, exact, out, limbs)
    want = _call(K.limb_mm_plain, form, side, e,
                 None if o is None else o.clone())
    target = o.clone() if o is not None else torch.zeros(want.shape)
    (kform, n, a0, a1, b, c, M, N, K_, lda, ldb, ldc, a_vec,
     b_vec) = K.kernel_args(side, e, target) if not form.startswith(
        "logits") else K.kernel_args(e, side, target)
    assert n == limbs and c is target
    assert kform == {"grad": K.FORM_GRAD, "sites_grad": K.FORM_GRAD,
                     "stored": K.FORM_STORED, "logits": K.FORM_LOGITS_KM,
                     "logits_t": K.FORM_LOGITS_MK}[form]
    assert (a1 is not None) == (kform == K.FORM_STORED and limbs == 2)
    got = _kernel_model(kform, limbs, a0, a1, b, c, M, N, K_, lda, ldb, ldc,
                        o is not None)
    np.testing.assert_allclose(got[:want.numel()].reshape(want.shape),
                               want.double().numpy(), rtol=1e-6, atol=1e-6)
    # 16-byte chunks only where the operand's rows allow them
    lq = L * Q
    if form == "sites_grad" or form == "logits_t":
        assert b_vec == int(lq * 2 % 16 == 0)
    else:
        assert b_vec == 1


def test_wrapper_refuses_what_the_kernel_does_not_take():
    rng = np.random.default_rng(5)
    r = torch.from_numpy(_f32(rng, (16, 27)))
    oh = torch.from_numpy(_one_hot(rng, 16, 1, 32)).to(torch.bfloat16)
    out = torch.zeros(27, 32)
    # dtypes
    with pytest.raises(ValueError, match="float32"):
        K.limb_mm(K.Split(r.T.double(), 2), oh)
    with pytest.raises(ValueError, match="bf16"):
        K.limb_mm(K.Split(r.T, 2), oh.float())
    with pytest.raises(ValueError, match="bf16 tensors"):
        K.limb_mm((r.T,), oh)
    with pytest.raises(ValueError, match="out must be float32"):
        K.limb_mm(K.Split(r.T, 2), oh, out.double())
    # shapes and sides
    with pytest.raises(ValueError, match="shapes"):
        K.limb_mm(K.Split(r, 2), oh)
    with pytest.raises(ValueError, match="out must be"):
        K.limb_mm(K.Split(r.T, 2), oh, torch.zeros(27, 31))
    with pytest.raises(ValueError, match="one limb side"):
        K.limb_mm(K.Split(r.T, 2), K.Split(r, 2))
    with pytest.raises(ValueError, match="one limb side"):
        K.limb_mm(r.T.bfloat16(), oh)
    # devices: neither the host nor a CUDA device, and operands on two
    meta = torch.empty((16, 32), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no K5 for device meta"):
        K.limb_mm(K.Split(torch.empty((27, 16), device="meta"), 2), meta)
    with pytest.raises(ValueError, match="several devices"):
        K.limb_mm(K.Split(r.T, 2), meta)
    # layouts the kernel does not take (the plain version takes any)
    with pytest.raises(ValueError, match="unit stride along its rows"):
        K.kernel_args(K.Split(r.T.contiguous(), 2), oh, out)
    with pytest.raises(ValueError, match="one-hot needs unit stride"):
        K.kernel_args(K.Split(r.T, 2), oh.T.contiguous().T, out)
    with pytest.raises(ValueError, match="out needs unit stride"):
        K.kernel_args(K.Split(r.T, 2), oh, torch.zeros(32, 27).T)
    J = torch.from_numpy(_f32(rng, (32, 54)))[:, ::2]
    with pytest.raises(ValueError, match="unit stride along one"):
        K.kernel_args(oh, K.Split(J, 2), torch.zeros(16, 27))
    with pytest.raises(ValueError, match="left side only"):
        K.kernel_args(oh, K.split_limbs(J.contiguous(), 2),
                      torch.zeros(16, 27))
    with pytest.raises(ValueError, match="K5 takes"):
        K.kernel_args(K.Split(r.T, 3), oh, out)


def test_host_tensors_count_no_launch():
    rng = np.random.default_rng(6)
    r = torch.from_numpy(_f32(rng, (16, 27)))
    oh = torch.from_numpy(_one_hot(rng, 16, 1, 32)).to(torch.bfloat16)
    before = K.limb_mm.launches
    K.limb_mm(K.Split(r.T, 2), oh, torch.zeros(27, 32))
    K.limb_mm(oh, K.Split(torch.from_numpy(_f32(rng, (32, 27))), 1))
    assert K.limb_mm.launches == before


def test_empty_products():
    oh = torch.zeros((0, 32), dtype=torch.bfloat16)
    r = torch.zeros((0, 27))
    out = torch.ones(27, 32)
    assert torch.equal(K.limb_mm(K.Split(r.T, 2), oh, out),
                       torch.ones(27, 32))
    assert torch.equal(K.limb_mm(K.Split(r.T, 2), oh), torch.zeros(27, 32))
