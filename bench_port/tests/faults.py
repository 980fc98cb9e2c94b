"""Faults planted in the program underneath a run, each of which the
comparison must catch: a solver step that returns its state unchanged,
a fit that stops early, half of every batch left out with the mean taken
over the rest, an answer altered where it is produced (one coupling block
of the fit, one score of the EC file). One chip, so no exchange between
chips to leave out."""

import dataclasses

import numpy as np


def frozen_step(monkeypatch):
    """Every LBFGS chunk reports its step but returns x and its state
    unchanged."""
    from evcouplings_torch.ops import plm

    real = plm.make_lbfgs_chunk

    def make(*args, **kwargs):
        chunk = real(*args, **kwargs)

        def frozen(x, state, *extra):
            return (x, state) + tuple(chunk(x, state, *extra)[2:])

        return frozen

    monkeypatch.setattr(plm, "make_lbfgs_chunk", make)


def early_stop(monkeypatch):
    """Every fit stops after its third iteration, as if its convergence
    test had passed there."""
    from evcouplings_torch.couplings import fitter
    from evcouplings_torch.ops import plm

    real = plm.fit_plm

    def fit(codes, weights, q, cfg, *args, **kwargs):
        cfg = dataclasses.replace(cfg, max_iter=min(cfg.max_iter, 3))
        return real(codes, weights, q, cfg, *args, **kwargs)

    monkeypatch.setattr(plm, "fit_plm", fit)
    monkeypatch.setattr(fitter, "fit_plm", fit)


def half_batch(monkeypatch):
    """Each value+gradient sees the first half of its rows, with their
    weights doubled (the mean over the rest)."""
    from evcouplings_torch.ops import plm

    real = plm._local_vg_carried

    def half(J_aug, codes, weights, L, q, block_size, acc, limbs=None):
        keep = codes.shape[0] // 2 // block_size * block_size or block_size
        return real(J_aug, codes[:keep], 2 * weights[:keep], L, q,
                    block_size, acc, limbs)

    monkeypatch.setattr(plm, "_local_vg_carried", half)


def altered_couplings(monkeypatch):
    """The fit returns its couplings with one pair's block negated."""
    from evcouplings_torch.ops import plm

    real = plm.fit_plm

    def fit(*args, **kwargs):
        res = real(*args, **kwargs)
        res.J_ij[0, 1] *= -1
        res.J_ij[1, 0] *= -1
        return res

    monkeypatch.setattr(plm, "fit_plm", fit)
    from evcouplings_torch.couplings import fitter
    monkeypatch.setattr(fitter, "fit_plm", fit)


def altered_score(monkeypatch):
    """The EC file's first CN score is written 1e-3 too high."""
    from evcouplings_torch.couplings import fitter

    real = fitter.write_raw_ec_file

    def write(path, index_list, target_seq, fn, cn):
        cn = np.array(cn, copy=True)
        cn[0, 1] += 1e-3
        return real(path, index_list, target_seq, fn, cn)

    monkeypatch.setattr(fitter, "write_raw_ec_file", write)


FAULTS = {"frozen_step": frozen_step, "early_stop": early_stop,
          "half_batch": half_batch,
          "altered_couplings": altered_couplings,
          "altered_score": altered_score}
