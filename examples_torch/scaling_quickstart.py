"""
Scaling quickstart with the PyTorch port: the two sharding regimes of the
Potts fit on a mesh of ranks.

1. Data parallel (symmetric fit, plmc semantics): MSA rows shard along
   a "data" axis, J replicated, gradients merged by an all-reduce.
2. Data x model parallel (asymmetric fit): sites — rows of J plus
   optimizer state — additionally shard along a "model" axis, for L
   beyond one card's memory. No collective crosses the model axis during
   the fit.

    python examples_torch/generate_data.py     # once
    python examples_torch/scaling_quickstart.py

PyTorch runs one process per rank, so the script starts its 8 ranks
itself (this file again, once per rank), joined over torch.distributed's
gloo backend through a rendezvous file in a temporary directory; rank 0
prints. Every rank computes on the CUDA device (on one card all eight
share it; gloo carries CUDA tensors through host memory), or on the host
with EVCOUPLINGS_TORCH_DEVICE=cpu.
"""

import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")

# unset: the CUDA device; EVCOUPLINGS_TORCH_DEVICE=cpu: the host
DEVICE = os.environ.get("EVCOUPLINGS_TORCH_DEVICE") or None

# ranks of the two meshes: (8,) "data" and (2, 4) "data" x "model"
WORLD = 8
# seconds a collective waits for the other ranks before it fails
COLLECTIVE_TIMEOUT = 600


def start_ranks():
    """Run this file once per rank, wait for all, and print rank 0's
    output; raise with the output of every rank that failed."""
    with tempfile.TemporaryDirectory(prefix="scaling_quickstart_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        logs = [os.path.join(tmp, "rank{}.log".format(r))
                for r in range(WORLD)]
        procs = []
        for rank, log in enumerate(logs):
            with open(log, "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--rank", str(rank), init],
                    stdout=out, stderr=subprocess.STDOUT))
        codes = [p.wait() for p in procs]
        texts = []
        for log in logs:
            with open(log) as f:
                texts.append(f.read())
    failed = [r for r, rc in enumerate(codes) if rc != 0]
    if failed:
        raise RuntimeError("ranks {} failed:\n{}".format(failed, "\n".join(
            "--- rank {} (exit {}) ---\n{}".format(r, codes[r], texts[r])
            for r in failed)))
    print(texts[0], end="")


def rank_main(rank, init):
    import torch
    import torch.distributed as dist

    from evcouplings_torch import parallel
    from evcouplings_torch.align.alignment import Alignment, map_matrix
    from evcouplings_torch.ops.plm import PlmConfig, fit_plm
    from evcouplings_torch.ops.plm_sites import fit_plm_asym
    from evcouplings_torch.ops.scores import cn_scores

    # each rank takes its share of the host's cores: eight ranks of one
    # thread pool each would oversubscribe them many times over
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // WORLD))
    parallel.distributed_initialize(init, WORLD, rank, backend="gloo",
                                    timeout=COLLECTIVE_TIMEOUT)
    # every rank creates both meshes, in the same order
    mesh_dp = parallel.make_mesh(device=DEVICE)
    mesh_2d = parallel.make_mesh_2d(2, 4, device=DEVICE)
    say = print if rank == 0 else (lambda *args: None)
    say("ranks: {} over {}, each on {}".format(
        WORLD, dist.get_backend(), mesh_dp.device))

    ali = Alignment.from_path(os.path.join(DATA, "demo_monomer.a2m"))
    codes = map_matrix(ali.matrix, ali.alphabet_map).astype(np.int8)
    N, L = codes.shape
    q = len(ali.alphabet)
    weights = np.ones(N)
    say("alignment: {} x {}, q={}".format(N, L, q))

    # --- regime 1: rows data-parallel over all 8 ranks ---
    res_dp = fit_plm(
        codes, weights, q,
        PlmConfig(solver="lbfgs", max_iter=60, block_size=32,
                  lambda_J=16.0),
        mesh=mesh_dp,
    )
    say("data-parallel symmetric fit: {} iters, loss {:.2f}".format(
        res_dp.num_iter, res_dp.final_loss))

    # --- regime 2: 2 x 4 data x model mesh, site-sharded asym fit ---
    res_2d = fit_plm_asym(
        codes, weights, q,
        PlmConfig(solver="adam", max_iter=300, block_size=32,
                  steps_per_call=25, lambda_J=16.0),
        mesh=mesh_2d,
    )
    say("data x model asymmetric fit: {} iters, loss {:.2f}".format(
        res_2d.num_iter, res_2d.final_loss))

    # both regimes find the same top couplings
    for name, res in (("dp", res_dp), ("2d", res_2d)):
        cn = cn_scores(res.J_ij)
        ii, jj = np.triu_indices(L, k=1)
        order = np.argsort(cn[ii, jj])[::-1][:4]
        pairs = sorted((int(ii[k]), int(jj[k])) for k in order)
        say("{} top-4 coupled column pairs: {}".format(name, pairs))
    dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(int(sys.argv[2]), sys.argv[3])
    else:
        start_ranks()
