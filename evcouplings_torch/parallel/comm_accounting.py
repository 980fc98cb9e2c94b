"""
Communication accounting for the sharded fits (port of
evcouplings_tpu/parallel/comm_accounting.py).

The JAX package reads the collectives of a step out of its compiled HLO.
The port has no compiled program to read: every collective it issues goes
through the functions of evcouplings_torch.parallel, which record each one
here as a CollectiveOp (operation, the operands' (dtype, shape) pairs in
the JAX package's HLO spelling, elements, bytes, and the mesh axis),
and collective_profile(fn, *args) returns what one call of fn recorded.
For the PLM gradient step the profile must be exactly ONE all-reduce of the
scalar NLL and the (Lq, Lq_aug) gradient block, nothing that grows with
the number of sequences N.

The analytic model (ring all-reduce cost, weak-scaling efficiency, the
affine fit of measured all-reduce times) is plain numpy, the JAX
package's. measure_all_reduce_cost times torch.distributed.all_reduce over
the ranks of the current default group.
"""

import time
from dataclasses import dataclass

import numpy as np
import torch

# the lists being recorded, innermost last (collective_profile nests)
_active = []


# torch dtypes in the JAX package's HLO spelling
_HLO_DTYPES = {
    torch.bool: "pred", torch.uint8: "u8", torch.int8: "s8",
    torch.int16: "s16", torch.int32: "s32", torch.int64: "s64",
    torch.float16: "f16", torch.bfloat16: "bf16", torch.float32: "f32",
    torch.float64: "f64",
}


@dataclass
class CollectiveOp:
    """One collective the port issued."""
    op: str                 # "all-reduce" | "broadcast"
    shapes: tuple           # ((dtype, (dims...)), ...), one per operand
    elements: int           # total elements moved
    bytes: int              # total payload bytes
    axis: str               # mesh axis, "mesh" (all its ranks) or "world"

    @property
    def is_reduction(self):
        return self.op == "all-reduce"


def record(op, axis, tensor, operand_shapes=None):
    """Note a collective of `tensor` (called by evcouplings_torch.parallel
    where it issues one). `operand_shapes`: the shapes of the operands
    packed into `tensor`, in order (default: `tensor` is the one operand);
    each travels in `tensor`'s dtype."""
    if _active:
        if operand_shapes is None:
            operand_shapes = (tuple(tensor.shape),)
        dtype = _HLO_DTYPES[tensor.dtype]
        _active[-1].append(CollectiveOp(
            op, tuple((dtype, tuple(s)) for s in operand_shapes),
            int(tensor.numel()),
            int(tensor.numel() * tensor.element_size()), axis))


def collective_profile(fn, *args, static_argnums=None, **kwargs):
    """Call fn(*args, **kwargs) and account the collectives it issued.
    Returns (ops, summary) where summary aggregates per-op counts,
    elements and bytes.

    static_argnums (the JAX package's): positions of arguments that are
    compile-time constants there. The port runs fn eagerly, so every
    argument reaches fn as the value it is, as a static one does; the
    positions must name arguments that were given."""
    for i in static_argnums or ():
        if not -len(args) <= i < len(args):
            raise ValueError("static_argnums {} out of range for {} "
                             "positional arguments".format(i, len(args)))
    ops = []
    _active.append(ops)
    try:
        fn(*args, **kwargs)
    finally:
        _active.pop()
    summary = {
        "count": len(ops),
        "all_reduce_count": sum(1 for o in ops if o.is_reduction),
        "non_reduction_ops": sorted(
            {o.op for o in ops if not o.is_reduction}),
        "elements": sum(o.elements for o in ops),
        "bytes": sum(o.bytes for o in ops),
    }
    return ops, summary


def expected_gradient_payload(L, q, acc_bytes=4):
    """The payload the PLM gradient step all-reduces: the scalar NLL plus
    the augmented gradient block dJh of shape (Lq, Lq_aug), Lq_aug = Lq + 1
    rounded up to a multiple of 128 (ops/plm.py _augmented_width). The
    useful content is exactly (Lq)^2 + Lq + 1 numbers."""
    from evcouplings_torch.ops.plm import _augmented_width

    lq = L * q
    lq_aug = _augmented_width(lq)
    padded_elements = lq * lq_aug + 1
    return {
        "useful_elements": lq * lq + lq + 1,
        "padded_elements": padded_elements,
        "bytes": padded_elements * acc_bytes,
        "lq": lq,
        "lq_aug": lq_aug,
    }


def ring_all_reduce_seconds(payload_bytes, devices, ici_bytes_per_s):
    """Ring (bandwidth-optimal) all-reduce cost per step: each device
    sends and receives 2 (d-1)/d of the payload over its links."""
    if devices <= 1:
        return 0.0
    return 2.0 * (devices - 1) / devices * payload_bytes / ici_bytes_per_s


def analytic_efficiency(rows_per_device, L, q, devices,
                        chip_seq_sites_per_s, ici_bytes_per_s,
                        acc_bytes=4):
    """Predicted weak-scaling efficiency of the PLM fit step.

    t_compute = rows_per_device * L / chip rate (per-device work grows
    with local rows); t_comm = ring all-reduce of the accounted gradient
    payload (constant in N). efficiency = t_c / (t_c + t_m).
    """
    payload = expected_gradient_payload(L, q, acc_bytes)
    t_compute = rows_per_device * L / chip_seq_sites_per_s
    t_comm = ring_all_reduce_seconds(payload["bytes"], devices,
                                     ici_bytes_per_s)
    total = t_compute + t_comm
    # no work and no communication is trivially efficient, not 0/0
    efficiency = t_compute / total if total > 0 else 1.0
    return {
        "devices": devices,
        "rows_per_device": rows_per_device,
        "sites": L,
        "q": q,
        "t_compute_ms": round(t_compute * 1e3, 4),
        "t_comm_ms": round(t_comm * 1e3, 4),
        "efficiency": round(efficiency, 4),
        "payload_bytes": payload["bytes"],
    }


def measure_all_reduce_cost(device_counts, payload_elems, reps=15,
                            dtype=None, device=None):
    """Median wall time of torch.distributed.all_reduce per (number of
    ranks d, payload), over meshes of the first d ranks of the default
    group; every rank calls it with the same arguments (the meshes'
    groups are created on all of them).

    Returns {d: {payload_elems: median_seconds}} on the ranks of each
    mesh (counts above the world size are skipped). Ranks that share one
    device, or the CPU, measure the host and the backend, not a link
    between cards. device: this rank's device (None: the current CUDA
    device)."""
    from evcouplings_torch import parallel

    dtype = torch.float32 if dtype is None else dtype
    out = {}
    for d in device_counts:
        if d > parallel.process_count():
            continue
        mesh = parallel.make_mesh(d, device=device)
        if mesh.coords is None:
            continue
        out[d] = {}
        for elems in payload_elems:
            x = torch.ones(int(elems), dtype=dtype, device=mesh.device)

            def once():
                parallel.all_reduce(x, mesh)
                if x.is_cuda:
                    torch.cuda.synchronize(x.device)

            once()
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                once()
                ts.append(time.perf_counter() - t0)
            out[d][elems] = float(np.median(ts))
    return out


def affine_cost_fit(measured):
    """Least-squares affine fit t(payload) = a + b * payload per mesh size
    from measure_all_reduce_cost output.

    Returns per-d records {devices, fixed_cost_s, per_elem_s, r2} plus the
    slope growth factors relative to the smallest mesh, beside the two
    theoretical brackets: the ring all-reduce factor 2(d-1)/d and the
    shared-bus factor d."""
    fits = []
    for d in sorted(measured):
        xs = np.array(sorted(measured[d]), dtype=float)
        ys = np.array([measured[d][int(e)] for e in xs])
        b, a = np.polyfit(xs, ys, 1)
        pred = a + b * xs
        ss_res = float(np.sum((ys - pred) ** 2))
        ss_tot = float(np.sum((ys - ys.mean()) ** 2))
        fits.append({
            "devices": int(d),
            "fixed_cost_s": float(a),
            "per_elem_s": float(b),
            "r2": 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0,
        })
    if not fits:
        raise ValueError("no measurements to fit")
    d0 = fits[0]["devices"]
    b0 = fits[0]["per_elem_s"]
    ring0 = 2.0 * (d0 - 1) / d0
    for f in fits:
        d = f["devices"]
        f["slope_growth_vs_d{}".format(d0)] = (
            f["per_elem_s"] / b0 if b0 > 0 else None)
        f["ring_factor_growth"] = (
            (2.0 * (d - 1) / d) / ring0 if ring0 > 0 else None)
        f["shared_bus_growth"] = d / d0
    return fits


def min_rows_for_efficiency(target, L, q, devices, chip_seq_sites_per_s,
                            ici_bytes_per_s, acc_bytes=4):
    """Smallest rows-per-device at which the model predicts at least
    `target` weak-scaling efficiency (target in (0, 1); exactly 1.0 is
    only reachable with zero communication)."""
    if not 0.0 < target < 1.0:
        raise ValueError(
            "target efficiency must be in (0, 1), got {}".format(target))
    payload = expected_gradient_payload(L, q, acc_bytes)
    t_comm = ring_all_reduce_seconds(payload["bytes"], devices,
                                     ici_bytes_per_s)
    if t_comm == 0.0:
        return 1  # single device: any batch is 100% efficient
    # eff >= target  <=>  t_compute >= t_comm * target / (1 - target)
    t_compute = t_comm * target / (1.0 - target)
    return int(np.ceil(t_compute * chip_seq_sites_per_s / L))
