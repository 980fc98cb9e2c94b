"""Seeded inputs of the sharded-fit tests and the worker that runs one rank
of them (numpy and the port only, no JAX).

tests/test_torch_parallel.py and tests/test_torch_distributed.py start
WORLD workers once per module with start_workers(), each as

    python tests/dist_fixtures.py SUITE RANK WORLD INIT_FILE OUT_DIR

a rank of a gloo process group on the CPU (file:// rendezvous in OUT_DIR).
Every rank runs every case of SUITE in the same order, so the collectives
line up, and pickles {case: result} to OUT_DIR/rank<RANK>.pkl; the tests
compare those results with the JAX package's on the same inputs, and with
the port in one process.
"""

import os
import pickle
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# seconds a collective may wait for the other ranks, and a whole run
COLLECTIVE_TIMEOUT = 120
RUN_TIMEOUT = 300


# ---------------------------------------------------------------------------
# inputs (the JAX package's own distributed and parallel tests' cases)
# ---------------------------------------------------------------------------

def count_case(name):
    """(codes, identity threshold) of a reweighting case
    (tests/test_parallel.py)."""
    if name == "500x60":
        rng = np.random.default_rng(5)
        m = rng.integers(0, 21, size=(500, 60))
        m[5] = m[3]
        m[499] = m[0]
        return m, 0.8
    rng = np.random.default_rng(6)
    return rng.integers(0, 5, size=(123, 40)), 0.5


COUNT_CASES = ("500x60", "123x40")


def covariance(D=43, seed=17):
    """A well-conditioned symmetric (D, D) matrix
    (tests/test_mean_field.py::TestShardedInversion)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((D, D))
    return A @ A.T + D * np.eye(D)


def fit_case(name):
    """(codes, weights, q, PlmConfig fields) of a symmetric fit case."""
    if name == "uneven":
        # tests/test_distributed.py's three-process case: 67 rows over
        # blocks of 8 do not split evenly
        rng = np.random.default_rng(1)
        codes = rng.integers(0, 4, size=(67, 5)).astype(np.int8)
        return (codes, rng.uniform(0.5, 1.0, size=67), 4,
                dict(max_iter=12, block_size=8, solver="adam"))
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 5, size=(64, 6)).astype(np.int8)
    cfg = {
        # the two-process case: one 32-row block per rank
        "adam": dict(max_iter=15, block_size=32, solver="adam"),
        "lbfgs": dict(max_iter=10, block_size=16, solver="lbfgs"),
        "fista": dict(max_iter=8, block_size=16, solver="fista",
                      lambda_group=2.0),
    }[name]
    return codes, np.ones(64), 5, cfg


FIT_CASES = ("adam", "uneven", "lbfgs", "fista")


def asym_case(name):
    """(codes, weights, q, PlmConfig fields, mesh shape) of an asymmetric
    fit case (tests/test_distributed.py's cross-process model and 2D
    meshes; "1x2@10" stops the first at 10 iterations)."""
    if name.startswith("1x2"):
        rng = np.random.default_rng(0)
        codes = rng.integers(0, 5, size=(64, 6)).astype(np.int8)
        return (codes, np.ones(64), 5,
                dict(max_iter=10 if name == "1x2@10" else 12,
                     block_size=32, solver="lbfgs", conv_tol=0.0), (1, 2))
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, size=(40, 6)).astype(np.int8)
    return (codes, np.ones(40), 4,
            dict(max_iter=10, block_size=8, solver="adam", conv_tol=0.0),
            (2, 2))


ASYM_CASES = ("1x2", "1x2@10", "2x2")


def profile_inputs(n, L=6, q=5, seed=3):
    """Codes, weights and a symmetric coupling matrix for one value+grad
    evaluation."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, q, size=(n, L)).astype(np.int8)
    J = rng.normal(size=(L * q, L * q)).astype(np.float32) * 0.1
    return codes, np.ones(n), 0.5 * (J + J.T), rng.normal(
        size=(L, q)).astype(np.float32)


def write_focus_a2m(path, N=60, L=7, seed=9):
    """A focus alignment (first row the target, uppercase columns) for the
    mean-field fit."""
    rng = np.random.default_rng(seed)
    aa = np.array(list("ACDEFGHIKLMNPQRSTVWY-"))
    mat = np.empty((N, L), dtype="U1")
    for col in range(L):
        mat[:, col] = rng.choice(aa, size=N,
                                 p=rng.dirichlet(np.ones(21) * 0.5))
    mat[0] = rng.choice(aa[:-1], size=L)
    with open(path, "w") as f:
        f.write(">TARGET/5-{}\n{}\n".format(4 + L, "".join(mat[0])))
        for i in range(1, N):
            f.write(">seq{}\n{}\n".format(i, "".join(mat[i])))


# ---------------------------------------------------------------------------
# the tests' side: start the workers and gather their results
# ---------------------------------------------------------------------------

def start_workers(suite, world, out_dir):
    """Start `world` ranks of `suite` (the caller may work meanwhile);
    wait_workers() collects them."""
    init = os.path.join(out_dir, "rendezvous")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(HERE), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "dist_fixtures.py"), suite,
         str(r), str(world), init, out_dir],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    return procs, out_dir


def wait_workers(started):
    """The ranks' result dicts by rank, once every rank has ended (at most
    RUN_TIMEOUT seconds; ranks still running then are killed). Raises
    AssertionError with the ranks' output when any of them failed."""
    procs, out_dir = started
    outputs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=RUN_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            out += b"\n(killed after %d s)" % RUN_TIMEOUT
        outputs.append(out.decode(errors="replace"))
    bad = [(r, p.returncode, o) for r, (p, o) in
           enumerate(zip(procs, outputs)) if p.returncode != 0]
    assert not bad, "\n".join("rank {} exit {}:\n{}".format(*b)[-4000:]
                              for b in bad)
    results = []
    for r in range(len(procs)):
        with open(os.path.join(out_dir, "rank{}.pkl".format(r)), "rb") as f:
            results.append(pickle.load(f))
    return results


# ---------------------------------------------------------------------------
# the worker's side
# ---------------------------------------------------------------------------

def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def _fit_result(res):
    return {"J": res.J_ij, "h": res.h_i, "fx": np.array(
        [r["fx"] for r in res.iteration_table]), "num_iter": res.num_iter,
        "final_loss": res.final_loss}


def _parallel_suite(out_dir):
    """Reweighting, the inversion, the mean-field fit, the collective
    profile and the helpers, on meshes of 2 and 3 ranks (world 3)."""
    import torch

    from evcouplings_torch import parallel
    from evcouplings_torch.align.alignment import Alignment
    from evcouplings_torch.couplings.mean_field import MeanFieldDCA
    from evcouplings_torch.ops.mean_field import invert_covariance_sharded
    from evcouplings_torch.ops.plm import (
        PlmConfig, make_plm_loss, make_plm_value_and_grad,
    )
    from evcouplings_torch.parallel import comm_accounting as ca

    meshes = {n: parallel.make_mesh(n, device="cpu") for n in (2, 3)}
    out = {}
    for n, mesh in meshes.items():
        member = mesh.coords is not None
        for case in COUNT_CASES:
            m, theta = count_case(case)
            out["counts", case, n] = (_np(parallel.num_cluster_members_sharded(
                m, theta, mesh)) if member else None)
        out["inverse", n] = (_np(invert_covariance_sharded(
            covariance(), mesh)) if member else None)
        if member:
            ali = Alignment.from_path(os.path.join(out_dir, "focus.a2m"),
                                      "fasta", device="cpu")
            model = MeanFieldDCA(ali).fit(theta=0.8, pseudo_count=0.5,
                                          mesh=mesh)
            out["mean_field", n] = {"J": model.J_ij, "h": model.h_i}
        for N in (64, 256):
            if not member:
                continue
            codes, w, J, h = profile_inputs(N)
            cfg = PlmConfig(block_size=16)
            rows, _ = parallel.shard_rows(codes, mesh, pad_multiple=16)
            w_loc, _ = parallel.shard_rows(w, mesh, pad_multiple=16)
            rows[(rows.shape[0] * mesh.index("data") + torch.arange(
                rows.shape[0])) >= N] = -1
            params = {"J": torch.tensor(J), "h": torch.tensor(h)}
            vg = make_plm_value_and_grad(6, 5, cfg, mesh=mesh)
            ops, summary = ca.collective_profile(vg, params, rows,
                                                 w_loc.float())
            _, loss_summary = ca.collective_profile(
                make_plm_loss(6, 5, cfg, mesh=mesh), params, rows,
                w_loc.float())
            out["profile", N, n] = {
                "summary": summary, "loss": loss_summary,
                "ops": [(o.op, o.axis, o.shapes, o.bytes) for o in ops],
                "value": float(vg(params, rows, w_loc.float())[0])}
    # rank r of a (data, model) mesh sits at (r // n_model, r % n_model)
    out["coords"] = {s: parallel.make_mesh_2d(*s, device="cpu").coords
                     for s in ((3, 1), (1, 3), (1, 2))}
    mesh = meshes[3]
    rows, n = parallel.shard_rows(np.arange(10 * 3).reshape(10, 3), mesh)
    rep = parallel.replicate({"a": np.full(4, float(mesh.rank)),
                              "b": [np.arange(3)]}, mesh)
    out["helpers"] = {
        "rows": _np(rows), "n": n, "a": _np(rep["a"]), "b": _np(rep["b"][0]),
        "object": parallel.broadcast_object(
            {"from": parallel.process_index()}),
        "coords": mesh.coords, "is_writer": mesh.is_writer}
    try:
        parallel.agree(mesh, parallel.process_index() == 1, "disagree")
        out["helpers"]["agree"] = "no error"
    except ValueError as exc:
        out["helpers"]["agree"] = str(exc)
    out["cost"] = ca.measure_all_reduce_cost([1, 2, 3, 4], [100, 10000],
                                             reps=2, device="cpu")
    return out


def _distributed_suite(out_dir):
    """The fits on meshes (world 4): the symmetric fit on 2 and 3 ranks
    for each solver, the asymmetric one on (1, 2) and (2, 2) meshes, the
    balanced LBFGS fit on one rank, the checkpoint guard, and the
    couplings stage with fit_devices 2. Rank 0 also runs each fit in one
    process, for the comparisons that must be bitwise."""
    from evcouplings_torch import parallel
    from evcouplings_torch.couplings import protocol
    from evcouplings_torch.ops import plm
    from evcouplings_torch.ops.plm import PlmConfig, fit_plm
    from evcouplings_torch.ops.plm_sites import fit_plm_asym

    rank = parallel.process_index()
    meshes = {n: parallel.make_mesh(n, device="cpu") for n in (2, 3)}
    meshes_2d = {s: parallel.make_mesh_2d(*s, device="cpu")
                 for s in ((1, 2), (2, 2))}
    out = {}
    for case in FIT_CASES:
        codes, w, q, kw = fit_case(case)
        for n, mesh in meshes.items():
            if mesh.coords is not None:
                out["fit", case, n] = _fit_result(fit_plm(
                    codes, w, q, PlmConfig(**kw), mesh=mesh))
        if rank == 0:
            out["fit", case, 1] = _fit_result(fit_plm(
                codes, w, q, PlmConfig(**kw), device="cpu"))
    for case in ASYM_CASES:
        codes, w, q, kw, shape = asym_case(case)
        mesh = meshes_2d[shape]
        if mesh.coords is not None:
            out["asym", case] = _fit_result(fit_plm_asym(
                codes, w, q, PlmConfig(**kw), mesh=mesh))
        if rank == 0:
            out["asym", case, 1] = _fit_result(fit_plm_asym(
                codes, w, q, PlmConfig(**kw), device="cpu"))

    # the balanced LBFGS fit ("high") on a mesh of one rank, without a
    # mesh, and the parity fit ("highest") without one: on the CPU each
    # takes the sequential chain
    codes, w, q, kw = fit_case("lbfgs")
    mesh1 = parallel.make_mesh(1, device="cpu")
    if mesh1.coords is not None:
        out["balanced"] = {
            name: _fit_result(fit_plm(
                codes, w, q, PlmConfig(**dict(kw, precision=precision)),
                **where))
            for name, precision, where in (
                ("mesh", "high", {"mesh": mesh1}),
                ("one", "high", {"device": "cpu"}),
                ("parity", "highest", {"device": "cpu"}))}

    # checkpoints: a file only rank 0 can see (a per-rank directory, the
    # stand-in for host-local disk) makes every rank raise
    codes, w, q, kw = fit_case("adam")
    mesh4 = parallel.make_mesh(4, device="cpu")
    local = os.path.join(out_dir, "host{}".format(rank))
    os.makedirs(local, exist_ok=True)
    if rank == 0:
        with open(os.path.join(local, "fit.npz"), "wb") as f:
            f.write(b"prior")
    try:
        fit_plm(codes, w, q, PlmConfig(**dict(kw, max_iter=4)), mesh=mesh4,
                checkpoint_file=os.path.join(local, "fit.npz"))
        out["guard"] = "no error"
    except ValueError as exc:
        out["guard"] = str(exc)
    # a shared file: only rank 0 writes it; a resumed fit equals an
    # uninterrupted one bitwise
    writes = []
    write_snapshot = plm.write_snapshot

    def spy(path, arrays):
        writes.append(path)
        write_snapshot(path, arrays)

    plm.write_snapshot = spy
    shared = os.path.join(out_dir, "shared_fit.npz")
    mesh = meshes[2]
    if mesh.coords is not None:
        fit_plm(codes, w, q, PlmConfig(**dict(kw, max_iter=4)), mesh=mesh,
                checkpoint_file=shared, checkpoint_every=2)
        resumed = fit_plm(codes, w, q, PlmConfig(**dict(kw, max_iter=8)),
                          mesh=mesh, checkpoint_file=shared)
        whole = fit_plm(codes, w, q, PlmConfig(**dict(kw, max_iter=8)),
                        mesh=mesh)
        out["resume"] = {"writes": len(writes),
                         "resumed": _fit_result(resumed),
                         "whole": _fit_result(whole)}
    plm.write_snapshot = write_snapshot

    # the couplings stage on 2 of the 4 ranks (ranks 2 and 3 are outside
    # the fit's mesh and receive rank 0's outcfg)
    with open(os.path.join(out_dir, "stage_in.pkl"), "rb") as f:
        stage_in = pickle.load(f)
    out["stage"] = protocol.run(
        protocol="standard", prefix=os.path.join(out_dir, "c2", "job"),
        fit_devices=2, **stage_in)
    return out


SUITES = {"parallel": _parallel_suite, "distributed": _distributed_suite}


def main(suite, rank, world, init_file, out_dir):
    import torch

    torch.set_num_threads(1)
    from evcouplings_torch import parallel

    parallel.distributed_initialize(
        "file://" + init_file, world, rank, backend="gloo",
        timeout=COLLECTIVE_TIMEOUT)
    results = SUITES[suite](out_dir)
    with open(os.path.join(out_dir, "rank{}.pkl".format(rank)), "wb") as f:
        pickle.dump(results, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
