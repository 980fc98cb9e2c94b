"""Sparse-couplings demo with the PyTorch port: exact group-L1
regularization.

With `lambda_g > 0` the fitter defaults to the proximal FISTA solver,
which treats the nonsmooth penalty lambda_g * sum_{i<j} ||J_ij||_F
EXACTLY — pair blocks reach exactly zero, so the surviving couplings
form a sparse interaction graph (plmc's -lg flag regime; the smooth
solvers refuse this configuration loudly instead of silently
approximating, see docs/configuration.md `group_mode`).

Run: python examples_torch/sparse_couplings_quickstart.py
(creates examples_torch/data via generate_data.py if missing; the fits
run on the CUDA device, or on the host with EVCOUPLINGS_TORCH_DEVICE=cpu)
"""

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
OUT = os.path.join(HERE, "output", "sparse")

# unset: the CUDA device; EVCOUPLINGS_TORCH_DEVICE=cpu: the host
DEVICE = os.environ.get("EVCOUPLINGS_TORCH_DEVICE") or None


def main():
    os.makedirs(OUT, exist_ok=True)
    msa = os.path.join(DATA, "demo_monomer.a2m")
    if not os.path.isfile(msa):
        subprocess.run(
            [sys.executable, os.path.join(HERE, "generate_data.py")],
            check=True,
        )

    import numpy as np

    from evcouplings_torch.couplings.fitter import run_plm
    from evcouplings_torch.couplings.model import CouplingsModel

    def fit(tag, lambda_g):
        model_file = os.path.join(OUT, tag + ".model")
        run_plm(
            msa, os.path.join(OUT, tag + "_ECs.txt"), model_file,
            focus_seq="DEMO_MONOMER/1-30",
            theta=0.8, iterations=300,
            lambda_h=0.01, lambda_J=2.0, lambda_g=lambda_g,
            steps_per_call=25, device=DEVICE,
        )
        m = CouplingsModel(model_file)
        norms = np.sqrt((m.J_ij ** 2).sum(axis=(2, 3)))
        ii, jj = np.triu_indices(m.L, k=1)
        return m, norms[ii, jj]

    # dense l2-only fit vs sparse group-L1 fit on the same family
    _, dense = fit("dense", 0.0)
    m, sparse = fit("sparse", 40.0)

    n_zero = int((sparse == 0.0).sum())
    print("pairs: {} total".format(len(sparse)))
    print("l2-only fit:  {} exactly-zero pair blocks".format(
        int((dense == 0.0).sum())))
    print("group-L1 fit: {} exactly-zero pair blocks "
          "({}% sparse)".format(
              n_zero, round(100 * n_zero / len(sparse))))
    survivors = np.argsort(-sparse)[: min(5, (sparse > 0).sum())]
    ii, jj = np.triu_indices(m.L, k=1)
    print("strongest surviving couplings:")
    for p in survivors:
        print("  {} - {}  ||J|| = {:.3f}".format(
            m.index_list[ii[p]], m.index_list[jj[p]], sparse[p]))


if __name__ == "__main__":
    main()
