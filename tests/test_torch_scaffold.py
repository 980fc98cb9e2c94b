"""The PyTorch port's package boundary: it imports neither JAX nor the
JAX package, its entry points refuse to fall back to the CPU quietly,
and its kernel wrappers count only launches of their kernels."""

import os
import re
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "golden")

PORT_MODULES = [
    "evcouplings_torch",
    "evcouplings_torch.align",
    "evcouplings_torch.align.alignment",
    "evcouplings_torch.align.ena",
    "evcouplings_torch.align.ids",
    "evcouplings_torch.align.pfam",
    "evcouplings_torch.align.protocol",
    "evcouplings_torch.align.tools",
    "evcouplings_torch.compare",
    "evcouplings_torch.compare.bcif",
    "evcouplings_torch.compare.distances",
    "evcouplings_torch.compare.ecs",
    "evcouplings_torch.compare.mapping",
    "evcouplings_torch.compare.pdb",
    "evcouplings_torch.compare.protocol",
    "evcouplings_torch.compare.sifts",
    "evcouplings_torch.convert",
    "evcouplings_torch.couplings.fitter",
    "evcouplings_torch.couplings.mapping",
    "evcouplings_torch.couplings.mean_field",
    "evcouplings_torch.couplings.model",
    "evcouplings_torch.couplings.pairs",
    "evcouplings_torch.couplings.protocol",
    "evcouplings_torch.couplings.tools",
    "evcouplings_torch.fold",
    "evcouplings_torch.fold.cns",
    "evcouplings_torch.fold.filter",
    "evcouplings_torch.fold.haddock",
    "evcouplings_torch.fold.protocol",
    "evcouplings_torch.fold.ranking",
    "evcouplings_torch.fold.restraints",
    "evcouplings_torch.fold.tools",
    "evcouplings_torch.kernels._build",
    "evcouplings_torch.kernels.adam_update",
    "evcouplings_torch.kernels.reweight",
    "evcouplings_torch.kernels.seqdot",
    "evcouplings_torch.mutate",
    "evcouplings_torch.mutate.calculations",
    "evcouplings_torch.mutate.protocol",
    "evcouplings_torch.native",
    "evcouplings_torch.ops.distances",
    "evcouplings_torch.ops.encode",
    "evcouplings_torch.ops.frequencies",
    "evcouplings_torch.ops.gauge",
    "evcouplings_torch.ops.hamiltonian",
    "evcouplings_torch.ops.lbfgs",
    "evcouplings_torch.ops.mean_field",
    "evcouplings_torch.ops.plm",
    "evcouplings_torch.ops.plm_sites",
    "evcouplings_torch.ops.plm_update",
    "evcouplings_torch.ops.sampling",
    "evcouplings_torch.ops.scores",
    "evcouplings_torch.ops.weights",
    "evcouplings_torch.utils.calculations",
    "evcouplings_torch.utils.config",
    "evcouplings_torch.utils.constants",
    "evcouplings_torch.utils.helpers",
    "evcouplings_torch.utils.pipeline",
    "evcouplings_torch.utils.system",
    "evcouplings_torch.utils.tracing",
    "evcouplings_torch.utils.tracker",
    "evcouplings_torch.utils.tracker.base",
    "evcouplings_torch.visualize",
    "evcouplings_torch.visualize.misc",
    "evcouplings_torch.visualize.mutations",
    "evcouplings_torch.visualize.pairs",
    "evcouplings_torch.visualize.parameters",
    "evcouplings_torch.visualize.pymol",
]


# public names of a JAX twin that the port does not have yet, each with
# the ROADMAP item that brings it
QUEUED_NAMES = {
    "evcouplings_torch.couplings.pairs": {           # A19d
        "logreg_classifier_from_dict", "logreg_classifier_to_dict"},
    "evcouplings_torch.couplings.protocol": {        # A19c
        "SCORING_MODELS", "complex_probability"},
    "evcouplings_torch.ops.mean_field": {            # A18
        "invert_covariance_sharded"},
    "evcouplings_torch.utils.helpers": {             # A19d
        "PersistentDict", "Progressbar", "retry"},
    "evcouplings_torch.utils.tracker": {             # A19d
        "TRACKER_MAX_NUM_RETRIES", "TRACKER_PASSWORD_KEY",
        "TRACKER_RETRY_WAIT", "TRACKER_USERNAME_KEY", "environ",
        "ResultTracker"},
    "evcouplings_torch.utils.tracker.base": {        # A19d
        "DEFAULT_FILE_COLLECTION", "DEFAULT_RESULT_COLLECTION",
        "ResultTracker"},
}
# public names the port has beside its twin's: device selection, the
# float64 host inversion and the distance blocks' size, the snapshot
# codec of checkpoint/resume, counters read by chip_smoke.py, dtypes
PORT_ADDED_NAMES = {
    "evcouplings_torch": {"resolve_device"},
    "evcouplings_torch.ops.distances": {"block_bytes"},
    "evcouplings_torch.ops.mean_field": {"F64", "invert_covariance"},
    "evcouplings_torch.ops.plm": {
        "ADAM_B1", "ADAM_B2", "ADAM_EPS", "fista_counts",
        "restore_snapshot", "snapshot_arrays", "write_snapshot"},
    "evcouplings_torch.ops.plm_sites": {"F32"},
}


def _public_names(module):
    """A module's public names: no _private names, no modules, and
    functions and classes only in the module that defines them (or, for a
    package, in one of its submodules): each package imports helpers of
    its own (torch's, jax's) that are not part of its surface."""
    import inspect

    own = module.__name__.replace("evcouplings_tpu", "evcouplings_torch")
    names = set()
    for name, value in vars(module).items():
        if name.startswith("_") or inspect.ismodule(value):
            continue
        if inspect.isfunction(value) or inspect.isclass(value):
            home = value.__module__.replace("evcouplings_tpu",
                                            "evcouplings_torch")
            if home != own and not (hasattr(module, "__path__")
                                    and home.startswith(own + ".")):
                continue
        names.add(name)
    return names


@pytest.mark.parametrize("name", [
    m for m in PORT_MODULES if not m.startswith(("evcouplings_torch.kernels",
                                                 "evcouplings_torch.convert"))])
def test_public_names_match_the_jax_twin(name):
    """Each ported module's public names are its JAX twin's, apart from
    the names still queued in ROADMAP.md (QUEUED_NAMES) and the port's
    own additions (PORT_ADDED_NAMES)."""
    import importlib

    port = _public_names(importlib.import_module(name))
    twin = _public_names(importlib.import_module(
        name.replace("evcouplings_torch", "evcouplings_tpu")))
    assert twin - port == QUEUED_NAMES.get(name, set())
    assert port - twin == PORT_ADDED_NAMES.get(name, set())


def test_import_leaves_jax_out():
    # a subprocess: this process already imported jax (tests/conftest.py)
    code = (
        "import importlib, sys\n"
        "for m in {!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('evcouplings_tpu') or m.startswith('jaxlib')"
        " or m.startswith('matplotlib')]\n"
        "assert not bad, bad\n"
        "print('ok')\n".format(PORT_MODULES))
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|evcouplings_tpu)\b"
    r"|from\s+(jax|jaxlib|evcouplings_tpu)\b)"
    r"|import_module\(\s*['\"](jax|evcouplings_tpu)"
    r"|__import__\(\s*['\"](jax|evcouplings_tpu)",
    re.M)


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "evcouplings_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_no_jax(path):
    with open(path) as f:
        src = f.read()
    assert not _FORBIDDEN.search(src), path


def test_entry_points_refuse_silent_cpu(monkeypatch, tmp_path):
    from evcouplings_torch.couplings.fitter import run_plm
    from evcouplings_torch.ops.plm import PlmConfig, fit_plm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_plm(os.path.join(GOLDEN, "golden.a2m"),
                str(tmp_path / "ec.txt"), device=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit_plm(np.zeros((4, 3), np.int8), np.ones(4), 2, PlmConfig())


def test_cpu_tensors_do_not_count_launches():
    from evcouplings_torch.kernels import adam_update, reweight, seqdot
    from evcouplings_torch.ops.plm_update import (
        fused_adam_update, fused_adam_update_presym,
    )
    from evcouplings_torch.ops.weights import num_cluster_members

    counters = (reweight.neighbor_counts, seqdot.sequential_dots,
                adam_update.fused_adam_update_cuda,
                adam_update.fused_adam_update_presym_cuda)
    before = [c.launches for c in counters]

    rng = np.random.default_rng(0)
    num_cluster_members(rng.integers(0, 5, (20, 7)), 0.8, device="cpu")
    seqdot.sequential_dot(torch.ones(10), torch.ones(10))
    lq = 6
    z = torch.zeros(lq, lq)
    fused_adam_update(torch.zeros(lq, lq + 2), z, z, z, 1.0, 1.0, q=3,
                      lambda_j=0.1, lr=0.1)
    fused_adam_update_presym(z, z, z, z, 1.0, 1.0, q=3, lambda_j=0.1,
                             lr=0.1)
    assert [c.launches for c in counters] == before

    # the CUDA wrappers themselves refuse CPU tensors
    with pytest.raises(ValueError):
        reweight.neighbor_counts(torch.zeros(4, 3, dtype=torch.int8), 2)
    with pytest.raises(ValueError):
        adam_update.fused_adam_update_cuda(
            torch.zeros(lq, lq), z, z, z, 1.0, 1.0, q=3, lambda_j=0.1,
            lr=0.1)
    assert [c.launches for c in counters] == before


def test_sequential_dot_is_an_fma_chain():
    from evcouplings_torch.kernels.seqdot import sequential_dot

    rng = np.random.default_rng(1)
    x = rng.normal(size=3001).astype(np.float32)
    y = rng.normal(size=3001).astype(np.float32)
    acc = np.float32(0.0)
    for a, b in zip(x, y):
        # fma(a, b, acc) in f32: the f64 product is exact, one rounding
        # of the f64 sum to f32 (a double rounding is possible in
        # principle but does not occur on these inputs)
        acc = np.float32(np.float64(a) * np.float64(b) + np.float64(acc))
    got = sequential_dot(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float32
    assert float(got) == float(acc)
    with pytest.raises(ValueError):
        sequential_dot(torch.ones(3, dtype=torch.float64),
                       torch.ones(3, dtype=torch.float64))


def test_new_entry_points_refuse_silent_cpu(monkeypatch, tmp_path):
    from evcouplings_torch.align.alignment import Alignment
    from evcouplings_torch.couplings.mean_field import MeanFieldDCA
    from evcouplings_torch.ops import mean_field
    from evcouplings_torch.ops.plm_sites import fit_plm_asym

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit_plm_asym(np.zeros((4, 3), np.int8), np.ones(4), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mean_field.direct_information(np.zeros((3, 3, 2, 2)),
                                      np.full((3, 2), 0.5))
    ali = Alignment.from_path(os.path.join(GOLDEN, "golden.a2m"), "fasta")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MeanFieldDCA(ali).fit()


def test_compare_entry_points_refuse_silent_cpu(monkeypatch, tmp_path):
    from evcouplings_torch.compare import protocol
    from evcouplings_torch.compare.distances import DistanceMap
    from evcouplings_torch.compare.pdb import Chain
    from evcouplings_torch.ops.distances import min_atom_distances

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        min_atom_distances([[0, 1]], np.zeros((2, 3)), [[0, 0]],
                           np.ones((1, 3)))
    residues = pd.DataFrame({"id": ["1", "2"]})
    coords = pd.DataFrame({"residue_index": [0, 1], "x": [0.0, 4.0],
                           "y": [0.0, 0.0], "z": [0.0, 0.0]})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DistanceMap.from_coords(Chain(residues, coords))
    assert DistanceMap.from_coords(Chain(residues, coords),
                                   device="cpu").dist(1, 2) == 4.0
    with pytest.raises(RuntimeError, match="device='cpu'"):
        protocol.run(protocol="standard", prefix=str(tmp_path / "c"),
                     ec_file=None, min_sequence_distance=6,
                     pdb_mmtf_dir=None, atom_filter=None,
                     compare_multimer=False, distance_cutoff=5,
                     target_sequence_file=None, scale_sizes=True)
    assert not os.listdir(tmp_path)
