"""The PyTorch port's package boundary: it imports neither JAX nor the
JAX package, its entry points refuse to fall back to the CPU quietly,
and its kernel wrappers count only launches of their kernels."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "golden")

PORT_MODULES = [
    "evcouplings_torch",
    "evcouplings_torch.convert",
    "evcouplings_torch.align.alignment",
    "evcouplings_torch.couplings.fitter",
    "evcouplings_torch.couplings.model",
    "evcouplings_torch.kernels._build",
    "evcouplings_torch.kernels.adam_update",
    "evcouplings_torch.kernels.reweight",
    "evcouplings_torch.kernels.seqdot",
    "evcouplings_torch.ops.encode",
    "evcouplings_torch.ops.frequencies",
    "evcouplings_torch.ops.gauge",
    "evcouplings_torch.ops.hamiltonian",
    "evcouplings_torch.ops.lbfgs",
    "evcouplings_torch.ops.plm",
    "evcouplings_torch.ops.plm_update",
    "evcouplings_torch.ops.scores",
    "evcouplings_torch.ops.weights",
    "evcouplings_torch.utils.system",
]


def test_import_leaves_jax_out():
    # a subprocess: this process already imported jax (tests/conftest.py)
    code = (
        "import importlib, sys\n"
        "for m in {!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('evcouplings_tpu') or m.startswith('jaxlib')]\n"
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

    counters = (reweight.neighbor_counts, seqdot.sequential_dot,
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
