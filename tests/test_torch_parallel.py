"""The port's evcouplings_torch.parallel against the JAX package's
evcouplings_tpu.parallel: sharded reweighting, the column-sharded
covariance inversion, the mean-field fit on a mesh, the collective profile
of a value+gradient evaluation, the mesh helpers and the communication
model.

The port runs one process per rank: three gloo workers on the CPU
(tests/dist_fixtures.py, started once for the module) form meshes of 2 and
3 ranks; the JAX side runs on its 8-virtual-device CPU mesh
(tests/conftest.py), as tests/test_parallel.py, test_mean_field.py and
test_scaling.py run it, while the workers run.
"""

import numpy as np
import pytest
import torch

import dist_fixtures as df
from evcouplings_tpu.align.alignment import Alignment as JaxAlignment
from evcouplings_tpu.couplings.mean_field import MeanFieldDCA as JaxMF
from evcouplings_tpu.ops.mean_field import (
    invert_covariance_sharded as jax_invert_sharded,
)
from evcouplings_tpu.parallel import comm_accounting as jca
from evcouplings_tpu.parallel import make_mesh as jax_make_mesh
from evcouplings_tpu.parallel import (
    num_cluster_members_sharded as jax_counts_sharded,
)
from evcouplings_torch.align.alignment import Alignment
from evcouplings_torch.couplings.mean_field import MeanFieldDCA
from evcouplings_torch.kernels.reweight import tile_range
from evcouplings_torch.ops.plm import PlmConfig, make_plm_value_and_grad
from evcouplings_torch.ops.weights import (
    _identity_count_threshold, _num_cluster_members_plain,
    num_cluster_members,
)
from evcouplings_torch.parallel import comm_accounting as ca

SIZES = (2, 3)
# the JAX tests' block sizes and mesh sizes of each reweighting case
JAX_COUNT_MESH = {"500x60": (8, 32), "123x40": (4, 16)}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The three ranks' results, and the JAX package's on the same inputs
    (computed while the ranks run)."""
    out = tmp_path_factory.mktemp("torch_parallel")
    a2m = str(out / "focus.a2m")
    df.write_focus_a2m(a2m)
    started = df.start_workers("parallel", 3, str(out))
    jax = {}
    for case in df.COUNT_CASES:
        m, theta = df.count_case(case)
        devices, block = JAX_COUNT_MESH[case]
        jax["counts", case] = jax_counts_sharded(
            m, theta, mesh=jax_make_mesh(devices), block_size=block)
    jax["inverse"] = np.asarray(jax_invert_sharded(df.covariance(),
                                                   jax_make_mesh()))
    model = JaxMF(JaxAlignment.from_file(open(a2m))).fit(
        theta=0.8, pseudo_count=0.5, mesh=jax_make_mesh())
    jax["mean_field"] = {"J": model.J_ij, "h": model.h_i}
    return df.wait_workers(started), jax, a2m


def _members(ranks, key, n):
    """The results of the ranks of the n-rank mesh (the first n)."""
    got = [r[key] for r in ranks[:n]]
    assert all(r.get(key) is None for r in ranks[n:])
    return got


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", df.COUNT_CASES)
def test_sharded_counts_equal_jax(run, case, n):
    """Exactly the JAX package's sharded counts (its 8- or 4-device mesh),
    and the port's one-process counts, on every rank."""
    ranks, jax, _ = run
    m, theta = df.count_case(case)
    whole = num_cluster_members(m, theta, device="cpu").numpy()
    for got in _members(ranks, ("counts", case, n), n):
        np.testing.assert_array_equal(got, jax["counts", case])
        np.testing.assert_array_equal(got, whole)


@pytest.mark.parametrize("parts", [2, 3, 7])
@pytest.mark.parametrize("case", df.COUNT_CASES)
def test_plain_tile_split_equals_whole_count(case, parts):
    """The plain version over `parts` ranges of K1's tiles sums exactly to
    the whole count (the split the ranks make)."""
    m, theta = df.count_case(case)
    codes = torch.as_tensor(m.astype(np.int8))
    k = _identity_count_threshold(m.shape[1], theta)
    total = sum(_num_cluster_members_plain(codes, k, tile_range(
        len(m), r, parts)) for r in range(parts))
    assert torch.equal(total, _num_cluster_members_plain(codes, k))


@pytest.mark.parametrize("n", SIZES)
def test_sharded_inverse_matches_numpy(run, n):
    """-inv(C) at D=43 (not a multiple of the rank count: padded columns)
    within atol 1e-8 of numpy and of the JAX package's sharded inverse,
    equal on every rank."""
    ranks, jax, _ = run
    C = df.covariance()
    got = _members(ranks, ("inverse", n), n)
    np.testing.assert_allclose(got[0], -np.linalg.inv(C), atol=1e-8)
    np.testing.assert_allclose(got[0], jax["inverse"], atol=1e-8)
    for other in got[1:]:
        np.testing.assert_array_equal(other, got[0])


@pytest.mark.parametrize("n", SIZES)
def test_mean_field_mesh_fit_matches_host_fit(run, n):
    """MeanFieldDCA.fit(mesh=) against the port's fit in one process and
    the JAX package's mesh fit: rtol 1e-4, atol 1e-6 (the JAX package's
    own mesh-vs-host tolerance)."""
    ranks, jax, a2m = run
    host = MeanFieldDCA(Alignment.from_path(a2m, "fasta", device="cpu")).fit(
        theta=0.8, pseudo_count=0.5)
    for got in _members(ranks, ("mean_field", n), n):
        for key, want in (("J", host.J_ij), ("h", host.h_i)):
            np.testing.assert_allclose(got[key], want, rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(got[key], jax["mean_field"][key],
                                       rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("N", [64, 256])
def test_one_all_reduce_per_evaluation(run, N, n):
    """A value+gradient evaluation on a mesh issues exactly one
    all-reduce, of expected_gradient_payload's bytes (the JAX package's
    count for the same shape), whatever N; a loss evaluation one of one
    float. The value equals the one-process evaluation (rtol 1e-6)."""
    ranks, _, _ = run
    L, q = 6, 5
    payload = ca.expected_gradient_payload(L, q)
    assert payload == jca.expected_gradient_payload(L, q)
    codes, w, J, h = df.profile_inputs(N)
    want = float(make_plm_value_and_grad(L, q, PlmConfig(block_size=16))(
        {"J": torch.tensor(J), "h": torch.tensor(h)},
        torch.as_tensor(codes), torch.as_tensor(w, dtype=torch.float32))[0])
    for got in _members(ranks, ("profile", N, n), n):
        assert got["summary"]["count"] == 1
        assert got["summary"]["all_reduce_count"] == 1
        assert got["summary"]["bytes"] == payload["bytes"]
        assert got["ops"] == [("all-reduce", "data", "float32",
                               payload["bytes"])]
        assert got["loss"]["all_reduce_count"] == 1
        assert got["loss"]["bytes"] == 4
        assert got["value"] == pytest.approx(want, rel=1e-6)


def test_mesh_helpers(run):
    """shard_rows pads and splits (JAX's padding), replicate and
    broadcast_object give every rank rank 0's values, agree raises on
    every rank when one disagrees, rank r of a (data, model) mesh sits at
    (r // n_model, r % n_model), and the first rank writes."""
    ranks, _, _ = run
    arr = np.arange(10 * 3).reshape(10, 3)
    padded = np.concatenate([arr, np.zeros((2, 3), arr.dtype)])
    for r, res in enumerate(ranks):
        helpers = res["helpers"]
        assert helpers["n"] == 10
        np.testing.assert_array_equal(helpers["rows"],
                                      padded[4 * r:4 * (r + 1)])
        np.testing.assert_array_equal(helpers["a"], np.zeros(4))
        np.testing.assert_array_equal(helpers["b"], np.arange(3))
        assert helpers["object"] == {"from": 0}
        assert helpers["agree"] == "disagree"
        assert helpers["coords"] == {"data": r}
        assert helpers["is_writer"] == (r == 0)
        assert res["coords"][3, 1] == {"data": r, "model": 0}
        assert res["coords"][1, 3] == {"data": 0, "model": r}
        assert res["coords"][1, 2] == (None if r == 2
                                       else {"data": 0, "model": r})


def test_all_reduce_cost_is_measured_per_mesh(run):
    """measure_all_reduce_cost reports each mesh of the first d ranks on
    its members, and skips d above the world size."""
    ranks, _, _ = run
    for r, res in enumerate(ranks):
        cost = res["cost"]
        assert sorted(cost) == [d for d in (1, 2, 3) if d > r]
        for d in cost:
            assert sorted(cost[d]) == [100, 10000]
            assert all(t > 0 for t in cost[d].values())


@pytest.mark.parametrize("fn,args", [
    ("ring_all_reduce_seconds", (4 * 3360 * 3456, 4, 1e11)),
    ("ring_all_reduce_seconds", (1000, 1, 1e11)),
    ("analytic_efficiency", (4096, 160, 21, 8, 5e8, 9e10)),
    ("analytic_efficiency", (0, 160, 21, 1, 5e8, 9e10)),
    ("min_rows_for_efficiency", (0.8, 160, 21, 8, 5e8, 9e10)),
    ("min_rows_for_efficiency", (0.9, 160, 21, 1, 5e8, 9e10)),
    ("affine_cost_fit", ({2: {100: 1e-4, 1000: 3e-4, 10000: 2.1e-3},
                          4: {100: 2e-4, 1000: 7e-4, 10000: 6.0e-3}},)),
])
def test_communication_model_matches_jax(fn, args):
    """The analytic model and the affine fit, on given numbers (not a
    timing): equal to the JAX package's."""
    assert getattr(ca, fn)(*args) == getattr(jca, fn)(*args)


def test_min_rows_refuses_a_target_of_one():
    with pytest.raises(ValueError):
        ca.min_rows_for_efficiency(1.0, 160, 21, 8, 5e8, 9e10)


def test_one_process_mesh_moves_nothing():
    """Without a process group: distributed_initialize for one process is
    a no-op, a mesh holds this one rank with no groups, its collectives
    leave tensors as they are, and a mesh of more ranks, or a run of
    several processes without a backend, is refused."""
    from evcouplings_torch import parallel

    parallel.distributed_initialize(num_processes=1)
    assert parallel.process_count() == 1
    mesh = parallel.make_mesh(device="cpu")
    assert (mesh.size, mesh.coords, mesh.group) == (1, {"data": 0}, None)
    assert mesh.is_writer
    mesh2d = parallel.make_mesh_2d(device="cpu")
    assert mesh2d.shape == {"data": 1, "model": 1}
    t = torch.arange(4.0)
    assert parallel.all_reduce(t, mesh) is t
    assert parallel.broadcast(t, mesh) is t
    assert [x.tolist() for x in parallel.all_reduce_many([t, t[:1]], mesh)] \
        == [[0.0, 1.0, 2.0, 3.0], [0.0]]
    assert parallel.broadcast_object({"a": 1}) == {"a": 1}
    assert parallel.data_sharding(mesh) == parallel.Sharding(mesh, "data")
    assert parallel.replicated_sharding(mesh).axis is None
    with pytest.raises(ValueError, match="needs 2 ranks"):
        parallel.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="backend"):
        parallel.distributed_initialize("tcp://localhost:1", 2, 0)
