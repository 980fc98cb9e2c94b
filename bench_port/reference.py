"""Plain reference of what the benchmark's cells compute, in PyTorch and
numpy: identity reweighting, weighted frequencies, the pseudolikelihood
objective and its gradient, limited-memory BFGS with libLBFGS's
backtracking line search, FN/APC scores, and readers of the plmc_v2
`.model` file and the raw EC file.

It imports nothing of the program. It runs in float64 by default, in
blocks of rows so that a deep alignment fits, with TF32 off. `dtype` and
`mantissa_bits` give a lower-precision control: float32 whose product
operands are rounded to nearest at that many mantissa bits (10: TF32, as
the tensor cores round them), the same on the CPU and on the card.

The Potts model is plmc's, in the fit's parametrisation: x = [P, h] with P
the (Lq, Lq) coupling matrix, J_eff = (P + P^T) / 2 with the L diagonal
q x q blocks zeroed, and

    f(P, h) = sum_n w_n sum_i m_ni (log Z_ni - logit_n[i, x_ni])
              + lambda_h |h|^2 + lambda_J / 2 |J_eff|^2,
    logit_n[i, a] = h[i, a] + sum_(j, b) onehot_n[j, b] J_eff[(j, b), (i, a)],

where m_ni is 0 at a position coded -1 (excluded) and 1 elsewhere.
"""

import contextlib
import math

import numpy as np
import torch

GAP_ALPHABET = "-ACDEFGHIKLMNPQRSTVWY"


@contextlib.contextmanager
def ieee_float32():
    """float32 products in IEEE float32, not TF32, restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def round_mantissa(x, bits):
    """float32 x rounded to nearest (ties away from zero) at `bits`
    mantissa bits, as the tensor cores convert float32 to TF32 (10)."""
    drop = 23 - bits
    i = x.contiguous().view(torch.int32)
    i = (i + (1 << (drop - 1))) & ~((1 << drop) - 1)
    return i.view(torch.float32)


def one_hot(codes, q, dtype):
    """(n, L) codes -> (n, L q); a code outside [0, q) gives zeros."""
    oh = codes.long().unsqueeze(-1) == torch.arange(q, device=codes.device)
    return oh.reshape(codes.shape[0], -1).to(dtype)


def cluster_counts(codes, theta, q, block=2048):
    """(n,) int64: for each row, the rows (itself included) whose share of
    equal columns, gaps included, is at least theta. The one-hot products
    are integers below 2^24, exact in IEEE float32."""
    n, L = codes.shape
    oh = one_hot(codes, q, torch.float32)
    counts = torch.empty(n, dtype=torch.int64, device=codes.device)
    with ieee_float32():
        for s in range(0, n, block):
            ident = (oh[s:s + block] @ oh.T).double() / L
            counts[s:s + block] = (ident >= theta).sum(dim=1)
    return counts


def frequencies(codes, weights, q):
    """(f_i (L, q), f_ij (L, L, q, q)) in float64, normalised by the sum of
    weights; the diagonal blocks of f_ij hold diag(f_i)."""
    n, L = codes.shape
    oh = one_hot(codes, q, torch.float64)
    w = weights.to(torch.float64)
    total = w.sum()
    fi = (w @ oh) / total
    fij = ((oh * w[:, None]).T @ oh) / total
    fij = fij.reshape(L, q, L, q).permute(0, 2, 1, 3).clone()
    idx = torch.arange(L)
    fij[idx, idx] = torch.diag_embed(fi.reshape(L, q))
    return fi.reshape(L, q).cpu().numpy(), fij.cpu().numpy()


class Plm:
    """The objective f(P, h) and its gradient over one alignment, in
    blocks of rows. x is the flat vector [P.flatten(), h.flatten()]."""

    def __init__(self, codes, weights, q, lambda_h, lambda_J,
                 dtype=torch.float64, mantissa_bits=None, block=4096):
        self.codes = codes
        self.weights = weights.to(dtype)
        self.L = codes.shape[1]
        self.q = q
        self.lq = self.L * q
        self.lambda_h = lambda_h
        self.lambda_J = lambda_J
        self.dtype = dtype
        self.mantissa_bits = mantissa_bits
        self.block = block
        site = torch.arange(self.lq, device=codes.device) // q
        self.mask = (site[:, None] != site[None, :]).to(dtype)

    def split(self, x):
        d = self.lq * self.lq
        return x[:d].reshape(self.lq, self.lq), x[d:].reshape(self.L, self.q)

    def operand(self, x):
        """A product's operand as the control rounds it."""
        if self.mantissa_bits is None:
            return x
        return round_mantissa(x, self.mantissa_bits)

    def value_grad(self, x):
        P, h = self.split(x)
        L, q = self.L, self.q
        J_eff = 0.5 * (P + P.T) * self.mask
        nll = torch.zeros((), dtype=self.dtype, device=x.device)
        G = torch.zeros_like(J_eff)
        dh = torch.zeros(self.lq, dtype=self.dtype, device=x.device)
        J_op = self.operand(J_eff)
        with ieee_float32():
            for s in range(0, self.codes.shape[0], self.block):
                c = self.codes[s:s + self.block]
                w = self.weights[s:s + self.block]
                oh = one_hot(c, q, self.dtype)
                logits = (oh @ J_op + h.reshape(-1)).reshape(-1, L, q)
                lse = torch.logsumexp(logits, dim=2)
                m = (c >= 0).to(self.dtype)
                obs = (oh.reshape(-1, L, q) * logits).sum(dim=2)
                nll = nll + torch.dot(w, ((lse - obs) * m).sum(dim=1))
                p = torch.softmax(logits, dim=2) * m[:, :, None]
                r = w[:, None] * (p.reshape(-1, self.lq) - oh)
                G += oh.T @ self.operand(r)
                dh += r.sum(dim=0)
        value = (nll + self.lambda_h * torch.sum(h * h)
                 + 0.5 * self.lambda_J * torch.sum(J_eff * J_eff))
        gP = 0.5 * (G + G.T) * self.mask + self.lambda_J * J_eff
        gh = dh.reshape(L, q) + 2.0 * self.lambda_h * h
        return value, torch.cat([gP.reshape(-1), gh.reshape(-1)])


def chain_dot(x, y):
    """x . y as one float32 sum in index order, each term rounded to
    float32 and added to the running sum (plmc's float32 LBFGS, whose dot
    products are such chains; over millions of terms the chain loses
    percents against the exact dot, and a fit follows it)."""
    a = x.to(torch.float32).cpu().numpy()
    b = y.to(torch.float32).cpu().numpy()
    s = np.add.accumulate(a * b, dtype=np.float32)[-1]
    return torch.tensor(float(s), dtype=x.dtype, device=x.device)


DOTS = {"exact": torch.dot, "sequential_float32": chain_dot}

# libLBFGS's backtracking line search with the strong Wolfe rule
C1, C2, GROW, SHRINK, MIN_CURVATURE, MAX_LS = 1e-4, 0.9, 2.1, 0.5, 1e-10, 40


def lbfgs(vg, x0, iterations, m=5, conv_tol=0.0, dot=torch.dot,
          callback=None):
    """Limited-memory BFGS from x0: the two-loop direction over the last m
    (s, y) pairs scaled by gamma = s.y / y.y, a first trial step of
    1 / |d| on the first iteration and 1 after, halving on an Armijo or
    far-side failure and growing 2.1x while the slope is still steep; the
    pair is kept while s.y > 1e-10. Stops after `iterations` accepted
    steps, at |g| <= conv_tol max(1, |x|), or when the line search fails.

    Returns (x, rows): rows holds (f, |g|, |x|) at each accepted iterate.
    `callback(k, x)`, where given, sees the iterate after k steps."""
    x = x0
    value, grad = vg(x)
    eps = torch.finfo(x.dtype).eps
    hist = []
    gamma = 1.0
    rows = []
    for it in range(iterations):
        qv = grad
        alphas = []
        for s, y, rho in reversed(hist):
            a = rho * dot(s, qv)
            alphas.append(a)
            qv = qv - a * y
        qv = qv * gamma
        for (s, y, rho), a in zip(hist, reversed(alphas)):
            b = rho * dot(y, qv)
            qv = qv + (a - b) * s
        d = -qv
        dphi0 = dot(grad, d)
        if dphi0 >= 0:
            d = -grad
            dphi0 = -dot(grad, grad)
        t = 1.0 / max(float(torch.sqrt(dot(d, d))), 1e-30) \
            if it == 0 else 1.0
        ok = done = False
        n_ls = 0
        while not done and n_ls < MAX_LS:
            value_t, grad_t = vg(x + t * d)
            t_eval = t
            dphi = dot(grad_t, d)
            armijo = bool(value_t <= value + C1 * t * dphi0)
            too_short = bool(dphi < C2 * dphi0)
            overshoot = bool(dphi > -C2 * dphi0)
            tiny = bool(t * abs(dphi0) <= eps * abs(value))
            ok = armijo and ((not too_short and not overshoot) or tiny)
            done = ok or (tiny and not armijo)
            if not armijo or overshoot:
                t *= SHRINK
            elif too_short:
                t *= GROW
            n_ls += 1
        if not ok:
            break
        s = t_eval * d
        y = grad_t - grad
        x = x + s
        sy = dot(s, y)
        if sy > MIN_CURVATURE:
            hist = (hist + [(s, y, 1.0 / sy)])[-m:]
            gamma = sy / dot(y, y)
        value, grad = value_t, grad_t
        gnorm = float(torch.sqrt(dot(grad, grad)))
        xnorm = float(torch.sqrt(dot(x, x)))
        rows.append((float(value), gnorm, xnorm))
        if callback is not None:
            callback(len(rows), x)
        if gnorm <= conv_tol * max(1.0, xnorm):
            break
    return x, rows


def flat_params(J_ij, h_i):
    """[P, h] of an (L, L, q, q) coupling tensor and (L, q) fields."""
    L, _, q, _ = J_ij.shape
    P = np.asarray(J_ij).transpose(0, 2, 1, 3).reshape(L * q, L * q)
    return np.concatenate([P.reshape(-1), np.asarray(h_i).reshape(-1)])


def unflat_couplings(P, L, q):
    """(L, L, q, q) float64 numpy of an (Lq, Lq) coupling matrix."""
    return np.asarray(P, dtype=np.float64).reshape(L, q, L, q).transpose(
        0, 2, 1, 3)


def fn_apc(J_ij):
    """(FN, CN): Frobenius norms of the zero-sum-gauge couplings, zero on
    the diagonal, and their average-product correction (Ekeberg et al.
    2013; Dunn et al. 2008), in float64."""
    J = np.asarray(J_ij, dtype=np.float64)
    L = J.shape[0]
    J0 = (J - J.mean(axis=3, keepdims=True) - J.mean(axis=2, keepdims=True)
          + J.mean(axis=(2, 3), keepdims=True))
    fn = np.sqrt((J0 ** 2).sum(axis=(2, 3)))
    fn[np.diag_indices(L)] = 0.0
    col = fn.mean(axis=0) * L / (L - 1)
    cn = fn - np.outer(col, col) / (fn.mean() * L / (L - 1))
    cn[np.diag_indices(L)] = 0.0
    return fn, cn


def read_model(path):
    """The arrays of a plmc_v2 `.model` file (little-endian float32)."""
    with open(path, "rb") as f:
        L, q, n_valid, n_invalid, num_iter = np.fromfile(f, "<i4", 5)
        theta, lambda_h, lambda_J, lambda_g, n_eff = np.fromfile(f, "<f4", 5)
        np.fromfile(f, "S1", q)
        weights = np.fromfile(f, "<f4", n_valid + n_invalid)
        np.fromfile(f, "S1", L)
        index_list = np.fromfile(f, "<i4", L)
        f_i = np.fromfile(f, "<f4", L * q).reshape(L, q)
        h_i = np.fromfile(f, "<f4", L * q).reshape(L, q)
        pairs = L * (L - 1) // 2
        f_ij_u = np.fromfile(f, "<f4", pairs * q * q).reshape(pairs, q, q)
        J_ij_u = np.fromfile(f, "<f4", pairs * q * q).reshape(pairs, q, q)
        rest = f.read()
    ii, jj = np.triu_indices(L, k=1)
    J = np.zeros((L, L, q, q))
    J[ii, jj] = J_ij_u
    J[jj, ii] = J_ij_u.transpose(0, 2, 1)
    f_ij = np.zeros((L, L, q, q))
    f_ij[ii, jj] = f_ij_u
    return {"L": int(L), "q": int(q), "num_iter": int(num_iter),
            "n_eff": float(n_eff), "weights": weights,
            "index_list": index_list, "f_i": f_i, "h_i": h_i,
            "f_ij_upper": f_ij, "J_ij": J, "trailing_bytes": len(rest)}


def read_ec(path):
    """(i, j, fn, cn) columns of a raw EC file `i A_i j A_j fn cn`."""
    cols = np.loadtxt(path, dtype=str, ndmin=2)
    return (cols[:, 0].astype(int), cols[:, 2].astype(int),
            cols[:, 4].astype(float), cols[:, 5].astype(float))


def rank_inversions(got, want, tie):
    """Pairs (a, b) ranked one way by `want` and the other by `got`, among
    pairs whose `want` scores differ by more than `tie`, counted over the
    top len(got) ** 0.5 entries of `want` against every other entry."""
    order = np.argsort(-want, kind="stable")
    top = order[:max(1, int(math.isqrt(len(want))))]
    bad = 0
    for a in top:
        sep = np.abs(want[a] - want) > tie
        bad += int(np.sum(sep & (np.sign(want[a] - want)
                                 != np.sign(got[a] - got))))
    return bad
