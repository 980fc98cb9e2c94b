"""
Multi-process parallelism over torch.distributed (port of
evcouplings_tpu/parallel/__init__.py).

The scaling axis is N, the alignment's rows: the reweighting counts and
the PLM gradients reduce over rows, so rows shard along one mesh axis
("data"), parameters and solver state are replicated, and the per-rank
contributions are summed by an all-reduce.

PyTorch runs one process per rank, where JAX drives every device of a mesh
from one controller. A rank computes on its own device: one card per rank
over the "nccl" backend, or several ranks on one card (or on the CPU) over
"gloo". Every collective of the port goes through the functions here
(all_reduce, broadcast, barrier, broadcast_object), which record it for
parallel/comm_accounting.collective_profile. They use only all-reduce and
broadcast: those are what gloo offers for CUDA tensors.

Entry points:
- distributed_initialize(): torch.distributed bring-up (no-op for one
  process)
- make_mesh() / make_mesh_2d(): the ranks on named axes, one process group
  per axis
- shard_rows() / replicate(): this rank's row block / a broadcast copy
- num_cluster_members_sharded(): O(N^2 L) reweighting split over ranks by
  ranges of K1's tiles
- (the fits take the mesh directly: ops.plm.fit_plm(mesh=...),
  ops.plm_sites.fit_plm_asym(mesh=...))
"""

import datetime
import os
import pickle
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from evcouplings_torch._device import resolve_device
from evcouplings_torch.parallel import comm_accounting

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _initialized():
    return dist.is_available() and dist.is_initialized()


def process_index():
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if _initialized() else 0


def process_count():
    """World size of the default group (1 without one)."""
    return dist.get_world_size() if _initialized() else 1


def distributed_initialize(coordinator_address=None, num_processes=None,
                           process_id=None, backend=None, timeout=None):
    """Initialize torch.distributed for a run of several processes (a
    no-op for one process).

    coordinator_address : init method URL ("tcp://host:port",
        "file:///path") or "host:port"; None reads the environment that
        torchrun sets (MASTER_ADDR, MASTER_PORT)
    num_processes, process_id : world size and rank; None reads WORLD_SIZE
        and RANK
    backend : "nccl" (one card per rank) or "gloo" (the CPU, or several
        ranks on one card); required for more than one process
    timeout : seconds a collective may wait for the other ranks (None:
        torch.distributed's default)

    With "nccl" the rank's card is LOCAL_RANK (else the rank modulo the
    card count), made the current CUDA device.
    """
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1:
        return
    if backend not in ("nccl", "gloo"):
        raise ValueError(
            "backend must be 'nccl' (one card per rank) or 'gloo' (the CPU, "
            "or several ranks on one card), got {!r}".format(backend))
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = "tcp://" + coordinator_address
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend=backend, init_method=init_method, world_size=num_processes,
        rank=process_id,
        **({} if timeout is None
           else {"timeout": datetime.timedelta(seconds=timeout)}))


class Mesh:
    """Ranks of the default process group laid out on named axes.

    ranks : int array of the axis sizes' shape; rank r of a
        ("data", "model") mesh sits at (r // n_model, r % n_model), where
        JAX's mesh places device r
    axis_names, shape : the axes and {axis: size}
    size : number of ranks
    rank, coords : this process's global rank and {axis: index} (coords
        None when the rank is not in the mesh)
    device : the torch device this rank computes on
    groups : {axis: process group of the ranks that share this rank's
        other coordinates}; group: all of the mesh's ranks. Both None
        without a process group (one process, nothing to communicate).
    """

    def __init__(self, ranks, axis_names, device):
        self.ranks = np.asarray(ranks)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.ranks.shape))
        self.size = int(self.ranks.size)
        self.device = resolve_device(device)
        self.rank = process_index()
        if self.size > process_count():
            raise ValueError(
                "Mesh {} needs {} ranks, only {} available; start the "
                "processes with distributed_initialize or torchrun".format(
                    self.shape, self.size, process_count()))
        where = np.argwhere(self.ranks == self.rank)
        self.coords = (dict(zip(self.axis_names, map(int, where[0])))
                       if len(where) else None)
        self.groups = dict.fromkeys(self.axis_names)
        self.group = None
        if not _initialized():
            return
        # every rank creates every group, in the same order
        for i, axis in enumerate(self.axis_names):
            lines = np.moveaxis(self.ranks, i, -1).reshape(
                -1, self.ranks.shape[i])
            for line in lines:
                g = dist.new_group(line.tolist())
                if self.rank in line:
                    self.groups[axis] = g
        g = dist.new_group(self.ranks.ravel().tolist())
        if self.coords is not None:
            self.group = g

    def __repr__(self):
        return "Mesh({}, rank {} at {}, {})".format(
            self.shape, self.rank, self.coords, self.device)

    def index(self, axis):
        """This rank's coordinate along `axis`."""
        if self.coords is None:
            raise ValueError("rank {} is not in {}".format(self.rank, self))
        return self.coords[axis]

    @property
    def is_writer(self):
        """Whether this rank writes the files of a sharded computation: the
        mesh's first rank (replicated results are equal on every rank)."""
        return self.coords is not None and self.rank == int(
            self.ranks.flat[0])


def make_mesh(n_devices=None, axis=DATA_AXIS, device=None):
    """1D mesh over the first n_devices ranks (all by default), with a
    single data-parallel axis. Every rank of the default group calls it.
    device: this rank's device (None: the current CUDA device)."""
    n = process_count() if n_devices is None else int(n_devices)
    return Mesh(np.arange(n), (axis,), device)


def make_mesh_2d(n_data=None, n_model=1, device=None):
    """2D ("data", "model") mesh: MSA rows shard along "data", sites (rows
    of the directed coupling matrix) along "model", the mesh of the
    site-sharded asymmetric fit (ops.plm_sites.fit_plm_asym). n_data
    defaults to all remaining ranks after the model axis is carved out."""
    n_model = int(n_model or 1)
    if n_data is None:
        n_data = max(1, process_count() // n_model)
    return Mesh(np.arange(n_data * n_model).reshape(n_data, n_model),
                (DATA_AXIS, MODEL_AXIS), device)


class Sharding(NamedTuple):
    """How an array lies on a mesh: axis 0 split over `axis`, or
    replicated (axis None)."""
    mesh: Mesh
    axis: object = None


def data_sharding(mesh, axis=DATA_AXIS):
    """Rows sharded along the data axis."""
    return Sharding(mesh, axis)


def replicated_sharding(mesh):
    """Fully replicated across the mesh."""
    return Sharding(mesh, None)


def _group(mesh, axis):
    return mesh.group if axis is None else mesh.groups[axis]


def all_reduce(tensor, mesh, axis=DATA_AXIS):
    """Sum `tensor` in place over the ranks of the mesh axis (axis None:
    the whole mesh); returns it. Nothing moves without a mesh or a process
    group."""
    return _all_reduce(tensor, mesh, axis, None)


def _all_reduce(tensor, mesh, axis, operand_shapes):
    group = None if mesh is None else _group(mesh, axis)
    if group is not None:
        comm_accounting.record("all-reduce", axis or "mesh", tensor,
                               operand_shapes)
        dist.all_reduce(tensor, group=group)
    return tensor


def all_reduce_many(tensors, mesh, axis=DATA_AXIS):
    """The tensors summed over the ranks of the mesh axis by ONE all-reduce
    of one buffer that packs them in order (the first stays aligned); the
    results are views of that buffer. Without a mesh, the tensors as they
    are."""
    if mesh is None:
        return list(tensors)
    buf = _all_reduce(torch.cat([t.reshape(-1) for t in tensors]), mesh,
                      axis, [t.shape for t in tensors])
    out, at = [], 0
    for t in tensors:
        out.append(buf[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def broadcast(tensor, mesh, axis=None, src=0):
    """Overwrite `tensor` in place with the copy of the src-th rank of the
    mesh axis (axis None: the whole mesh); returns it."""
    group = _group(mesh, axis)
    if group is not None:
        comm_accounting.record("broadcast", axis or "mesh", tensor)
        dist.broadcast(tensor, src=dist.get_global_rank(group, src),
                       group=group)
    return tensor


def barrier(mesh):
    """Wait for every rank of the mesh, by an all-reduce of one number."""
    all_reduce(torch.zeros(1, device=mesh.device), mesh, axis=None)


def _world_device():
    """Device for the default group's own tensors: the current card under
    nccl, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_object(obj=None, src=0):
    """`obj` of rank src on every rank of the default group (a pickle, sent
    as its length and then its bytes by two broadcasts). Without a process
    group, obj itself."""
    if not _initialized():
        return obj
    dev = _world_device()
    data = (pickle.dumps(obj) if process_index() == src else b"")
    size = torch.tensor([len(data)], dtype=torch.int64, device=dev)
    comm_accounting.record("broadcast", "world", size)
    dist.broadcast(size, src=src)
    buf = torch.zeros(int(size), dtype=torch.uint8, device=dev)
    if process_index() == src:
        buf.copy_(torch.frombuffer(bytearray(data), dtype=torch.uint8))
    comm_accounting.record("broadcast", "world", buf)
    dist.broadcast(buf, src=src)
    return pickle.loads(buf.cpu().numpy().tobytes())


def agree(mesh, value, what):
    """Raise ValueError on every rank of the mesh unless all hold the same
    number `value` (rank 0's copy is broadcast, mismatches are summed)."""
    if mesh.group is None:
        return
    ref = broadcast(torch.tensor([float(value)], dtype=torch.float64,
                                 device=mesh.device), mesh)
    bad = all_reduce((ref != float(value)).to(torch.float64), mesh,
                     axis=None)
    if float(bad):
        raise ValueError(what)


def shard_rows(array, mesh, axis=DATA_AXIS, pad_multiple=None):
    """This rank's block of axis 0 of `array`, on its device, after padding
    axis 0 with zeros to a multiple of the axis size x pad_multiple.

    Returns (row block tensor, original row count)."""
    from evcouplings_torch.ops.encode import pad_rows

    padded, n = pad_rows(np.asarray(array),
                         mesh.shape[axis] * (pad_multiple or 1))
    rows = padded.shape[0] // mesh.shape[axis]
    k = mesh.index(axis)
    return torch.as_tensor(padded[k * rows:(k + 1) * rows],
                           device=mesh.device), n


def replicate(tree, mesh):
    """Every array of a tree (dicts, lists, tuples of arrays) as a tensor on
    each rank's device, holding the mesh's first rank's values (one
    broadcast per array)."""
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(v, mesh) for v in tree)
    t = tree if isinstance(tree, torch.Tensor) else torch.as_tensor(
        np.asarray(tree))
    return broadcast(t.to(mesh.device, copy=True).contiguous(), mesh)


def num_cluster_members_sharded(matrix_mapped, identity_threshold,
                                mesh=None, block_size=1024):
    """Sequence reweighting split over the mesh's "data" ranks: each rank
    counts the pairs of one of equal contiguous ranges of K1's upper-
    triangle tiles (kernels/reweight.tile_range; K1's range launch on the
    card, the plain version restricted to the same tiles on the CPU) into
    a zeroed full-length int32 vector, and one int32 all-reduce sums them.
    The sum is exact and independent of order, and the total work is one
    whole launch's.

    Same contract as ops.weights.num_cluster_members: (N,) float64 counts,
    on this rank's device. Every rank passes the same matrix. block_size
    is accepted for the JAX package's signature (its blocked scan); the
    split here is by K1's 128-row tiles.
    """
    from evcouplings_torch.kernels.reweight import tile_range
    from evcouplings_torch.ops.weights import (
        _codes_tensor, _identity_count_threshold, _neighbor_counts,
    )

    del block_size
    if mesh is None:
        mesh = make_mesh()
    codes = _codes_tensor(matrix_mapped, mesh.device).to(mesh.device)
    n, L = codes.shape
    min_count = _identity_count_threshold(L, identity_threshold)
    tiles = tile_range(n, mesh.index(DATA_AXIS), mesh.shape[DATA_AXIS])
    counts = _neighbor_counts(codes, min_count, tiles)
    return all_reduce(counts, mesh).to(torch.float64)
