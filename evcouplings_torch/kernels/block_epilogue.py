"""
Python wrapper of K6, the bf16 row block's epilogue of the PLM value+grad
in one pass (evcouplings_torch/csrc/block_epilogue.cu), and its plain
version, the PyTorch chain every other route takes.

Per row s of a block of logits x (B, Lq = L q, the bf16 output of the
logits product), codes c (B, L) (-1: gap or padding, m = 0) and weights
w (B,), in float32:

    rowmax = max_k x[k]
    e[k]   = exp(max(x[k] - rowmax, SOFTMAX_SHIFT_FLOOR))
    Z[r]   = sum of e over site r's q lanes
    term   = sum_r m_r (x[r, c_r] - rowmax - log Z[r])
    r[k]   = w (e[k] m_r / Z[r] - onehot[k])       rounded once to bf16
    t      = w term                                 float32, one per row

The caller sums t over all rows in a fixed order into the evaluation's
NLL (-sum t) and takes the gradient product over r. The observed lane
follows from the code, so the one-hot is not read. The source says what
bounds the kernel and how its design meets it.

ops/plm.py takes K6 where fuses_epilogue holds (bf16 compute on a CUDA
device) and block_epilogue_plain everywhere else. The two agree to bf16
rounding, not bit for bit: the plain chain computes e, m/Z, their
product, the difference and the weighting in bf16 (5-6 roundings per
residual, with the weights rounded to bf16) and sums the observed logits
in bf16, where K6 keeps every step in float32 and rounds the residual
once, at its store. CUDA tensors launch K6 or raise; CPU tensors raise
too: the CPU takes block_epilogue_plain, whose contract differs (it
returns the block's NLL and a new residual).
"""

import ctypes

import torch

from evcouplings_torch.kernels import _build

SOURCE = "block_epilogue"
_SYMBOLS = {
    "evc_block_epilogue": [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ],
}
# a row's logits (bf16) in one block's shared memory (kMaxSmem)
MAX_ROW_BYTES = 227 * 1024

# lower clamp on (logits - rowmax) before exp. The shift is the whole
# row's max, so a site whose logits all sit far below it could underflow
# its whole q-segment to zero (Z = 0 -> inf residuals). exp(-80) is a
# normal number in f32 and bf16, so Z >= q exp(-80) > 0; for any site
# within ~80 nats of the row max the clamp only touches lanes below f32
# resolution.
SOFTMAX_SHIFT_FLOOR = -80.0


def fuses_epilogue(dtype, device):
    """Whether a row block's epilogue is K6 (block_epilogue): bf16
    compute on a CUDA device. Every other route (float32 and float64 at
    any precision, and everything on the CPU) takes block_epilogue_plain."""
    return dtype == torch.bfloat16 and torch.device(device).type == "cuda"


def block_epilogue_plain(logits, oh, c, w, L, q, acc):
    """(block NLL contribution, residual r) of one row block in PyTorch.

    logits: (B, Lq) in the compute dtype; oh: (B, Lq) one-hot of the
    codes c (B, L) (a view of the augmented one-hot); w: (B,) weights in
    the compute dtype; acc: the accumulation dtype of the sums. The
    per-site softmax sums are reductions over each site's q lanes (the
    JAX package takes them as products against a 0/1 segment matrix;
    the sums are the same)."""
    B = logits.shape[0]
    lq = L * q
    rowmax = logits.amax(dim=1, keepdim=True)
    e = torch.exp(torch.clamp(logits - rowmax, min=SOFTMAX_SHIFT_FLOOR))
    Z = e.reshape(B, L, q).sum(dim=2, dtype=acc)

    # sum_r log P(x_sr|..) = sum_r [logit_obs - rowmax - log Z_r], with
    # m zeroing gap / padding positions
    m_acc = (c >= 0).to(acc)
    obs = (oh * logits).sum(dim=1).to(acc)
    logZ = ((torch.log(Z) + rowmax.to(acc)) * m_acc).sum(dim=1)
    nll_b = -torch.dot(w.to(acc), obs - logZ)

    # r = w * (softmax * m - oh), each site's factor broadcast over its q
    # lanes
    rz = (m_acc / Z).to(logits.dtype)
    bcast = rz[:, :, None].expand(B, L, q).reshape(B, lq)
    r = w[:, None] * (e * bcast - oh)
    return nll_b, r


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError("{} is on {}, expected {}".format(
            name, t.device, device))
    if t.dtype != dtype:
        raise ValueError("{} must be {}, got {}".format(name, dtype, t.dtype))
    if tuple(t.shape) != shape:
        raise ValueError("{} must have shape {}, got {}".format(
            name, shape, tuple(t.shape)))
    if t.dim() and t.stride(-1) != 1:
        raise ValueError("{} must have unit stride along its last "
                         "axis".format(name))


def block_epilogue(logits, codes, weights, q, r_out, terms_out):
    """Launch K6 on one row block: logits (B, L q) bf16, codes (B, L)
    int8, weights (B,) float32, all CUDA tensors with unit stride along
    their last axis; writes the bf16 residual into r_out (B, L q) (rows
    of the caller's buffer: any row stride) and each row's weighted
    log-pseudolikelihood w_s term_s into terms_out (B,) float32. Raises
    on a CPU tensor: the CPU takes block_epilogue_plain."""
    if not logits.is_cuda:
        raise ValueError("K6 needs CUDA tensors; the CPU takes "
                         "block_epilogue_plain")
    device = logits.device
    B, L = codes.shape
    lq = L * q
    if q < 1 or 2 * lq > MAX_ROW_BYTES:
        raise ValueError("K6 takes rows of at most {} bf16 logits, got L={} "
                         "q={}".format(MAX_ROW_BYTES // 2, L, q))
    _check("logits", logits, torch.bfloat16, (B, lq), device)
    _check("codes", codes, torch.int8, (B, L), device)
    _check("weights", weights, torch.float32, (B,), device)
    _check("r_out", r_out, torch.bfloat16, (B, lq), device)
    _check("terms_out", terms_out, torch.float32, (B,), device)
    # 16-byte rows: every row of the logits and of the residual starts on
    # a 16-byte boundary
    vec = lq % 8 == 0 and all(
        t.data_ptr() % 16 == 0 and (t.stride(0) * 2) % 16 == 0
        for t in (logits, r_out))
    lib = _build.load(SOURCE, _SYMBOLS)
    with torch.cuda.device(device):
        err = lib.evc_block_epilogue(
            logits.data_ptr(), logits.stride(0), codes.data_ptr(),
            codes.stride(0), weights.data_ptr(), r_out.data_ptr(),
            r_out.stride(0), terms_out.data_ptr(), B, L, q,
            SOFTMAX_SHIFT_FLOOR, int(vec), _build.stream_of(logits))
    _build.check_launch(lib, err, "K6 (block_epilogue)")
    block_epilogue.launches += 1


# launches of K6
block_epilogue.launches = 0
