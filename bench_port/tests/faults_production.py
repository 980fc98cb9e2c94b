"""Faults planted in the production fit (Adam steps, the two-phase
layout), which faults.py's frozen_step and half_batch do not reach: they
patch the LBFGS chunk and the carried layout. altered_couplings and
early_stop of faults.py patch fit_plm itself and reach it as they are."""


def frozen_adam_step(monkeypatch):
    """Every Adam step, fused or not, reports its row but returns the
    parameters and the solver state unchanged."""
    from evcouplings_torch.ops import plm

    for name in ("_make_adam_step", "_make_fused_adam_step"):
        real = getattr(plm, name)

        def make(*args, _real=real, **kwargs):
            step = _real(*args, **kwargs)

            def frozen(params, state, *rows):
                return (params, state) + tuple(step(params, state,
                                                    *rows)[2:])

            return frozen

        monkeypatch.setattr(plm, name, make)


def half_batch_two_phase(monkeypatch):
    """Each value+gradient of the two-phase layout sees the first half of
    its rows, with their weights doubled (the mean over the rest)."""
    from evcouplings_torch.ops import plm

    real = plm._local_vg_two_phase

    def half(J_aug, codes, weights, oh_all, L, q, block_size, acc,
             limbs=None):
        keep = codes.shape[0] // 2 // block_size * block_size or block_size
        return real(J_aug, codes[:keep], 2 * weights[:keep], oh_all[:keep],
                    L, q, block_size, acc, limbs)

    monkeypatch.setattr(plm, "_local_vg_two_phase", half)


FAULTS = {"frozen_adam_step": frozen_adam_step,
          "half_batch_two_phase": half_batch_two_phase}
