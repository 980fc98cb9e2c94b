"""Plain reference of the production fit's solver: Adam as optax.adam
defines it (scale_by_adam with eps_root 0, then a step of -lr), over the
flat parameter vector x = [P, h] of a reference.Plm objective, from zero.

It imports nothing of the program. Its rows record, as the program's do,
f and |g| at the iterate before each update and |x| after it.
"""

import torch

B1, B2, EPS, LR = 0.9, 0.999, 1e-8, 5e-3


def adam_step(x, g, mu, nu, count, lr=LR):
    """One Adam update of x by its gradient g, with the moments mu and nu
    before it and `count` the steps taken before this one: (x', mu',
    nu')."""
    count = count + 1
    mu = B1 * mu + (1.0 - B1) * g
    nu = B2 * nu + (1.0 - B2) * (g * g)
    mu_hat = mu / (1.0 - B1 ** count)
    nu_hat = nu / (1.0 - B2 ** count)
    return x - lr * (mu_hat / (torch.sqrt(nu_hat) + EPS)), mu, nu


def adam(vg, x0, iterations, lr=LR, callback=None):
    """`iterations` Adam steps from x0 over vg(x) -> (f, g).

    Returns (x, rows): rows holds (f, |g|, |x|) of each step, f and |g| at
    the iterate the step started from and |x| at the one it reached.
    `callback(k, x)`, where given, sees the iterate after k steps."""
    x = x0
    mu = torch.zeros_like(x0)
    nu = torch.zeros_like(x0)
    rows = []
    for k in range(iterations):
        value, g = vg(x)
        x, mu, nu = adam_step(x, g, mu, nu, k, lr)
        rows.append((float(value), float(torch.linalg.vector_norm(g)),
                     float(torch.linalg.vector_norm(x))))
        if callback is not None:
            callback(k + 1, x)
    return x, rows
