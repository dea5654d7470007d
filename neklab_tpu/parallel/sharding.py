"""SPMD element partitioning over a JAX device mesh.

The reference's single parallelism strategy is MPI domain decomposition of
spectral elements (SURVEY section 2.3). The counterpart here: one mesh
axis 'e', every field sharded along its element axis, all cross-element
communication (dssum scatter/gather, global-DOF CG vectors, mass-dot psums)
emitted by XLA's SPMD partitioner from these shardings:

  * element-local tensor-product kernels: fully parallel, zero comms;
  * dssum / global scatter: all-reduce of the global-DOF accumulation
    (correct everywhere; the halo-exchange optimized path rides on top);
  * Krylov dots: psum — the reference's glsc3 allreduce.

The device mesh is a flat list of devices (on one host the cards are joined
all to all). Multi-host: the same program under jax.distributed with the 'e'
axis spanning every device of every process — nothing here changes.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

# element-axis position per field name (element-LAST layout: -1 everywhere
# except unsharded global/scalar fields)
_SEM_MESH_AXES = {
    "x": -1, "jac": -1, "rx": -1, "bm1": -1, "g": -1, "xd": -1, "rxd": -1,
    "bmd": -1, "bm2": -1, "binv": -1, "gidx": -1, "vmult": -1, "vmask": -1,
    "pmask": -1, "tmask": -1, "vmask_hat": None, "tmask_hat": None, "gfirst": None,
    "volume": None,
    # face-pair exchange schedule (unstructured 2-D meshes): REPLICATED.
    # The schedule indexes the [n, 4*nel] stacked face strips globally; the
    # strips themselves are O(surface) data, so the partitioner's gather
    # (face-strip all-gather) moves ~n/(n*n) ~ 1/n of a field per exchange —
    # bounded by the collective-pattern test on the .re2 mesh. Element->chip
    # locality comes from RCB element ordering (mesh_from_re2 partition=...).
    "fp_pidx": None, "fp_flip": None, "fp_mask": None, "fp_vsib": None,
    "fp_roll_mask": None, "fp_rem_dst": None, "fp_rem_src": None,
    "vs_roll_mask": None, "vs_rem_dst": None, "vs_rem_src": None,
    "eperm": None,
}
_FLOW_STATE_AXES = {
    "u": -1, "p": -1, "theta": -1, "ulag": -1, "nlag": -1, "tlag": -1,
    "ntlag": -1, "plag": -1, "time": None,
}


def make_device_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), ("e",))


def _spec(ndim_arr: int, elem_axis: int | None) -> P:
    if elem_axis is None:
        return P()
    parts = [None] * ndim_arr
    parts[elem_axis % ndim_arr] = "e"
    return P(*parts)


def _shard_dataclass(obj, axes: dict, dmesh: Mesh):
    updates = {}
    for f in dataclasses.fields(obj):
        if f.name not in axes:
            continue
        val = getattr(obj, f.name)
        if not hasattr(val, "ndim"):
            continue
        spec = _spec(val.ndim, axes[f.name])
        updates[f.name] = jax.device_put(val, NamedSharding(dmesh, spec))
    return dataclasses.replace(obj, **updates)


def shard_sem_mesh(mesh, dmesh: Mesh):
    """Shard every SemMesh array along its element axis over 'e'.

    The element count must be divisible by the device count (XLA shards
    evenly); choose the mesh/partition accordingly — e.g.
    mesh_from_re2(..., partition=ndev) with ndev | nel."""
    ndev = int(np.prod(list(dmesh.shape.values())))
    if mesh.nel % ndev != 0:
        raise ValueError(
            f"element count {mesh.nel} is not divisible by the device count "
            f"{ndev}; pick a divisor device count or pad the mesh"
        )
    return _shard_dataclass(mesh, _SEM_MESH_AXES, dmesh)


def shard_flow_state(state, dmesh: Mesh):
    """Shard a FlowState/PertState along element axes over 'e'."""
    axes = {k: v for k, v in _FLOW_STATE_AXES.items()
            if any(f.name == k for f in dataclasses.fields(state))}
    return _shard_dataclass(state, axes, dmesh)


def shard_field(f, dmesh: Mesh, elem_axis: int):
    return jax.device_put(f, NamedSharding(dmesh, _spec(f.ndim, elem_axis)))


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> Mesh:
    """Multi-host SPMD entry point (SURVEY section 7 stage 7).

    Calls jax.distributed.initialize with the coordinator address, process
    count and this process's id (a plain GPU host provides no cluster
    environment, so all three are needed there), then builds the global 'e'
    mesh over ALL devices: the same single-axis element partition, with XLA
    emitting the face-exchange/psum collectives across devices and hosts.
    This is the analog of the reference's
    `mpiexec -np N nek5000` scale-out — the compiled program is identical
    to the single-host one.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)
    return make_device_mesh()
