"""
Python wrapper of K5, the bf16-limb product of the precision names
"high" and "default" (evcouplings_torch/csrc/limb_mm.cu), and its plain
version.

The JAX package defines those names as 2 and 1 bf16 limbs of the float32
operand of every one-hot product (evcouplings_tpu/ops/plm.py,
_PrecTriple / _precision). ops/plm.py and ops/plm_sites.py take their
one-hot products on the card through limb_mm: one launch per product,
every limb pass into one float32 accumulator per output element, the
float32 operand split as the kernel loads it, and, where the product is
added into a gradient, the sum added into that tensor in place.

Operands. One side of a product is the limb side: a Split (a float32
tensor and its number of limbs, 1 or 2), or a tuple of stored bf16 limbs
(the residual store of the two-phase layouts). The other side is exactly
bf16 (a one-hot). The kernel takes three forms:

    out (+)= split(S) @ E    S a float32 (M, K) view with unit stride
                             along M (r.T), E (K, N) bf16 rows;
    out (+)= stored @ E      the same, S given as its bf16 limbs;
    out  = E @ split(S)      E (M, K) bf16 rows, S (K, N) float32 with
                             either unit stride (J_aug or J_eff.T).

CUDA tensors launch K5, or raise on a dtype, device, shape or layout the
kernel does not take; CPU tensors take the plain version, which is the
route the card took before K5: the limbs by split_limbs, one float32
product per pair of limbs (torch.mm(..., out_dtype=float32) on a CUDA
tensor, which only tests and chip_smoke.py give it), summed largest limb
first, then added into `out`.
"""

import ctypes

import torch

from evcouplings_torch.kernels import _build

SOURCE = "limb_mm"
# the kernel's forms (enum Form in csrc/limb_mm.cu)
FORM_GRAD, FORM_STORED, FORM_LOGITS_KM, FORM_LOGITS_MK = 0, 1, 2, 3
# limb counts the kernel takes
KERNEL_LIMBS = (1, 2)
_SYMBOLS = {
    "evc_limb_mm": [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ],
    "evc_limb_mm_warpgroups": [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
    ],
}


class Split:
    """A float32 operand that its product takes in `n` bf16 limbs
    (split_limbs), split where the product loads it."""

    __slots__ = ("x", "n")

    def __init__(self, x, n):
        self.x = x
        self.n = n

    @property
    def T(self):
        return Split(self.x.T, self.n)


def is_limbs(x):
    """Whether x is a limb side: a Split or a tuple of bf16 limbs."""
    return isinstance(x, (Split, tuple))


def split_limbs(x, n):
    """n bfloat16 limbs of a float32 tensor, largest first: the first is x
    rounded to bf16, each next one what the limbs before it leave of x,
    rounded to bf16 (that rest is exact in float32). Two limbs hold x to
    within 2^-17 of it, relative; three hold it exactly."""
    limbs = [x.to(torch.bfloat16)]
    rest = x
    for _ in range(n - 1):
        rest = rest - limbs[-1]
        limbs.append(rest.to(torch.bfloat16))
    return tuple(limbs)


def _parts(x):
    """The bf16 factors of one side: a Split's limbs, a tuple as it is, an
    exact operand as its one bf16 self."""
    if isinstance(x, Split):
        return split_limbs(x.x, x.n)
    return x if isinstance(x, tuple) else (x.to(torch.bfloat16),)


def _mm_f32(a, b):
    """a @ b of bf16 operands with a float32 output: torch.mm with
    out_dtype on a CUDA tensor, float32 operands on the CPU (exact
    products either way, float32 accumulation)."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def limb_mm_plain(a, b, out=None):
    """The plain version of limb_mm: one float32 product per pair of bf16
    factors, largest limb first, each added to the sum of those before;
    then added into `out` when it is given (and returned)."""
    total = None
    for x in _parts(a):
        for y in _parts(b):
            p = _mm_f32(x, y)
            total = p if total is None else total.add_(p)
    return total if out is None else out.add_(total)


def _tensors(side):
    if isinstance(side, Split):
        return (side.x,)
    return side if isinstance(side, tuple) else (side,)


def _check(a, b, out):
    """The checks both versions make: one limb side, bf16 on the other,
    float32 or bf16 limbs, matching shapes, one device."""
    if is_limbs(a) == is_limbs(b):
        raise ValueError("limb_mm takes one limb side (a Split or a tuple "
                         "of bf16 limbs) and one exact bf16 side")
    limb, exact = (a, b) if is_limbs(a) else (b, a)
    if isinstance(limb, Split):
        if limb.x.dtype != torch.float32:
            raise ValueError("a Split holds a float32 tensor, got {}".format(
                limb.x.dtype))
        if limb.n < 1:
            raise ValueError("a Split takes 1 or more limbs, got {}".format(
                limb.n))
    elif not limb or any(t.dtype != torch.bfloat16 for t in limb):
        raise ValueError("stored limbs are bf16 tensors")
    if exact.dtype != torch.bfloat16:
        raise ValueError("the exact side of a limb product is bf16, got "
                         "{}".format(exact.dtype))
    tensors = _tensors(a) + _tensors(b) + ((out,) if out is not None else ())
    if any(t.dim() != 2 for t in tensors):
        raise ValueError("limb_mm takes 2-D operands")
    shapes = {tuple(t.shape) for t in _tensors(limb)}
    if len(shapes) != 1:
        raise ValueError("stored limbs of different shapes: {}".format(
            sorted(shapes)))
    (m, k), (k2, n) = _tensors(a)[0].shape, _tensors(b)[0].shape
    if k != k2:
        raise ValueError("limb_mm of shapes {} and {}".format(
            (m, k), (k2, n)))
    if out is not None and (tuple(out.shape) != (m, n)
                            or out.dtype != torch.float32):
        raise ValueError("out must be float32 of shape {}, got {} {}".format(
            (m, n), out.dtype, tuple(out.shape)))
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError("limb_mm operands on several devices: {}".format(
            sorted(str(d) for d in devices)))
    return m, n, k


def _unit(t, dim):
    """Whether t has unit stride along dim (or a single entry there)."""
    return t.stride(dim) == 1 or t.shape[dim] == 1


def _ld(t, dim):
    """The stride of t along dim, the row pitch the kernel reads."""
    return max(t.stride(dim), 1) if t.shape[dim] > 1 else max(
        t.shape[1 - dim], 1)


def _aligned(t, ld):
    """16-byte base and row pitch: whole chunks by cp.async."""
    return int(t.data_ptr() % 16 == 0 and (ld * t.element_size()) % 16 == 0)


def kernel_args(a, b, out):
    """The kernel's form and operands for a product the wrapper takes:
    (form, limbs, a0, a1, b, c, M, N, K, lda, ldb, ldc, a_vec, b_vec), the
    pointers as tensors. Raises ValueError on a layout the kernel does not
    take."""
    if is_limbs(a):
        # out (M, N) += limbs(S) @ E, S (M, K) with unit stride along M
        limb, e = a, b
        S = _tensors(limb)
        M, K = S[0].shape
        N = e.shape[1]
        if not all(_unit(s, 0) for s in S):
            raise ValueError("the limb side on the left needs unit stride "
                             "along its rows (a transposed view, r.T)")
        lds = {_ld(s, 1) for s in S}
        if len(lds) != 1:
            raise ValueError("stored limbs with different row pitches")
        lda = lds.pop()
        form = FORM_GRAD if isinstance(limb, Split) else FORM_STORED
        if not _unit(e, 1):
            raise ValueError("the one-hot needs unit stride along its "
                             "columns")
        ldb = _ld(e, 0)
        if not _unit(out, 1):
            raise ValueError("out needs unit stride along its columns")
        ldc = _ld(out, 0)
        kM, kN = M, N
    else:
        # out (Mo, No) = E @ split(S): the kernel computes out^T, M = No,
        # N = Mo
        e, limb = a, b
        if not isinstance(limb, Split):
            raise ValueError("stored limbs are taken on the left side only")
        S = (limb.x,)
        K, No = S[0].shape
        Mo = e.shape[0]
        if _unit(S[0], 1):
            form, lda = FORM_LOGITS_KM, _ld(S[0], 0)
        elif _unit(S[0], 0):
            form, lda = FORM_LOGITS_MK, _ld(S[0], 1)
        else:
            raise ValueError("the split operand needs unit stride along "
                             "one dimension")
        if not _unit(e, 1):
            raise ValueError("the one-hot needs unit stride along its "
                             "columns")
        ldb = _ld(e, 0)
        if not _unit(out, 1):
            raise ValueError("out needs unit stride along its columns")
        ldc = _ld(out, 0)
        kM, kN = No, Mo
    limbs = limb.n if isinstance(limb, Split) else len(limb)
    if limbs not in KERNEL_LIMBS:
        raise ValueError("K5 takes {} limbs, got {}".format(
            KERNEL_LIMBS, limbs))
    a_vec = int(all(_aligned(s, lda) for s in S))
    return (form, limbs, S[0], S[1] if len(S) > 1 else None, e, out, kM, kN,
            K, lda, ldb, ldc, a_vec, _aligned(e, ldb))


def instantiation(a, b, out):
    """(form, limbs, warpgroups per block): the kernel instantiation that
    a K5 launch of this product (CUDA operands, `out` the float32 output)
    runs on the current device."""
    (form, limbs, _a0, _a1, _e, _c, M, N, *_) = kernel_args(a, b, out)
    lib = _build.load(SOURCE, _SYMBOLS)
    wg = ctypes.c_int(0)
    with torch.cuda.device(out.device):
        err = lib.evc_limb_mm_warpgroups(M, N, ctypes.byref(wg))
    _build.check_launch(lib, err, "evc_limb_mm_warpgroups")
    return form, limbs, wg.value


def _launch(a, b, out, accumulate):
    (form, limbs, a0, a1, e, c, M, N, K, lda, ldb, ldc, a_vec,
     b_vec) = kernel_args(a, b, out)
    lib = _build.load(SOURCE, _SYMBOLS)
    with torch.cuda.device(c.device):
        err = lib.evc_limb_mm(
            form, limbs, a0.data_ptr(),
            a1.data_ptr() if a1 is not None else None, e.data_ptr(),
            c.data_ptr(), M, N, K, lda, ldb, ldc, a_vec, b_vec,
            int(accumulate), _build.stream_of(c))
    _build.check_launch(lib, err, "evc_limb_mm")
    limb_mm.launches += 1
    return c


def limb_mm(a, b, out=None):
    """a @ b where one side is a limb side (a Split, or a tuple of stored
    bf16 limbs) and the other is exactly bf16: the sum of the limb
    products in float32. With `out`, the product is added into that
    float32 tensor in place and it is returned; else a new float32
    tensor. CUDA tensors launch K5 (one launch), CPU tensors take
    limb_mm_plain."""
    m, n, k = _check(a, b, out)
    device = (out if out is not None else _tensors(a)[0]).device
    if device.type == "cpu":
        return limb_mm_plain(a, b, out)
    if device.type != "cuda":
        raise ValueError("no K5 for device {}".format(device))
    accumulate = out is not None
    if out is None:
        out = torch.empty((m, n), dtype=torch.float32, device=device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out if accumulate else out.zero_()
    return _launch(a, b, out, accumulate)


# launches of K5
limb_mm.launches = 0
