"""Multi-host execution environment (P8).

Replacement for the reference's MPI environment
(initialize_mpi / terminate_mpi, io_routines.f90:3610-3656): each host
runs the SAME program (the reference's ranks do too); jax.distributed
connects them.  The PRODUCTION model mirrors the reference's MPI
decomposition: every process traces a rank-strided slice of each
stage's sources on its own LOCAL rays/wave mesh, and the field/scaspe
accumulators are summed once per stage (split_source_set +
allreduce_sum = the src loop + reduce_u_*_arr).  All stage-level
decisions are taken on the reduced results, so processes stay in
lockstep without explicit synchronization.

Entry points:

* ``initialize()`` — call once at program start in every process.  Reads
  the coordination settings from the environment when arguments are
  omitted (``DARTRAY_COORDINATOR``, ``DARTRAY_NUM_PROCS``,
  ``DARTRAY_PROC_ID``; clusters that JAX auto-detects need none).  When
  the coordinator is on this host, each process opens only the card with
  its own process index, so several processes share one multi-GPU host.
  The CLI calls this first thing when ``DARTRAY_MULTIHOST=1`` is set.
* ``split_source_set(sources)`` / ``allreduce_sum(x)`` / ``agree(tag,
  v)`` — the production P8 layer used by rt.engine / pipeline.
* ``global_ray_mesh()`` — 1-D 'rays' mesh over ALL devices of all hosts
  (the alternative fully-global path; exercised by
  tests/multihost_worker.py mode "stage").
* ``host_local_batch(mesh, spec, arrays)`` — wrap per-process host numpy
  into global jax Arrays sharded by `spec` (each process feeds the shard
  its devices own; the host data must be identical on every process,
  exactly like the reference's replicated source loop,
  rt_routines.f90:1003-1005).
"""
from __future__ import annotations

import os

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


_LOCAL_HOSTS = ("localhost", "127.0.0.1", "[::1]")


def local_device_ids(coordinator: str, process_id: int):
    """Devices this process opens: ``[process_id]`` when the coordinator
    runs on this host (every process of the run shares the host, one card
    each — a JAX process would otherwise reserve memory on every card and
    starve the others), else None (each host's process opens all of its
    cards)."""
    if coordinator is None or process_id is None:
        return None
    if coordinator.rsplit(":", 1)[0] in _LOCAL_HOSTS:
        return [process_id]
    return None


def initialize(coordinator: str = None, num_processes: int = None,
               process_id: int = None):
    """jax.distributed.initialize with env-var fallbacks; no-op if the
    distributed runtime is already up.  Must run before ANY other jax
    call that initializes the backend (so also before jax.devices /
    jax.process_count)."""
    if getattr(initialize, "_done", False):
        return
    coordinator = coordinator or os.environ.get("DARTRAY_COORDINATOR")
    if num_processes is None and os.environ.get("DARTRAY_NUM_PROCS"):
        num_processes = int(os.environ["DARTRAY_NUM_PROCS"])
    if process_id is None and os.environ.get("DARTRAY_PROC_ID"):
        process_id = int(os.environ["DARTRAY_PROC_ID"])
    kw = {}
    if coordinator:
        kw.update(coordinator_address=coordinator,
                  num_processes=num_processes, process_id=process_id,
                  local_device_ids=local_device_ids(coordinator, process_id))
    jax.distributed.initialize(**kw)
    initialize._done = True


def global_ray_mesh() -> Mesh:
    """1-D 'rays' mesh over every device of every process."""
    return Mesh(np.array(jax.devices()), ("rays",))


# ---------------------------------------------------------------------------
# Source-decomposition multi-process execution (the production P8 path)
# ---------------------------------------------------------------------------
#
# The reference's MPI model is rank-wise source splitting with a field
# reduction at stage end (the src loop strides by rank, and
# reduce_u_fest_arr/reduce_u_final_arr sum the per-rank accumulators,
# io_routines.f90:3667-3986).  The equivalent here keeps that outer
# layer: each PROCESS traces an interleaved slice of the stage's sources on
# its own local device mesh (where rays/wave shard_map parallelism still
# applies), and the per-process field/scaspe accumulators are summed once
# per stage.  All stage-level control flow (convergence tests, scattering
# source selection, the ladder regroup) runs on the REDUCED arrays, so
# every process takes identical decisions and the collectives stay aligned
# without any explicit synchronization — exactly the reference's
# "every rank runs the same program" contract.


def split_sources(n: int):
    """Indices of this process's share of `n` stage sources (the
    reference's rank-strided source loop).

    NOTE: checkpoint/restore (`restore_file_mpi`) under multi-process
    runs assumes a SHARED filesystem — process 0 writes every output
    (io_output.is_writer) and all processes must see the same files for
    check_files to keep their control flow in lockstep, exactly like the
    reference's MPI ranks."""
    return np.arange(jax.process_index(), n, jax.process_count())


def split_source_set(sources):
    """Rank-strided slice of a SourceSet for this process (shared by the
    field and observer stages)."""
    if jax.process_count() == 1:
        return sources
    import dataclasses

    sel = split_sources(sources.n)
    return dataclasses.replace(
        sources, pos=sources.pos[sel], cell=sources.cell[sel],
        sid=sources.sid[sel], lum=np.asarray(sources.lum)[sel],
    )


def allreduce_sum(x):
    """Sum `x` (device array / numpy / scalar) across processes; no-op in
    single-process runs.  Goes through host allgather — one call per
    stage, the analog of reduce_u_*_arr (io_routines.f90:3667-3986).
    (A production pod would psum over a global mesh instead of the two
    host round trips this costs; the stage-level granularity keeps that
    swap local to this function.)

    Integer counters are reduced exactly even in 32-bit sessions (where an
    int64 -> jnp conversion would wrap) by splitting them into two int32
    halves."""
    if jax.process_count() == 1:
        return x
    from jax.experimental import multihost_utils

    import jax.numpy as jnp

    host = np.asarray(x)
    if np.issubdtype(host.dtype, np.integer):
        h = host.astype(np.int64)
        lo = (h & 0x3FFFFFFF).astype(np.int32)
        hi = (h >> 30).astype(np.int32)
        lo_t = np.asarray(
            multihost_utils.process_allgather(lo), dtype=np.int64
        ).sum(axis=0)
        hi_t = np.asarray(
            multihost_utils.process_allgather(hi), dtype=np.int64
        ).sum(axis=0)
        tot = ((hi_t << 30) + lo_t).astype(host.dtype, casting="unsafe")
        return tot if host.ndim else host.dtype.type(tot)
    tot = np.asarray(multihost_utils.process_allgather(host)).sum(axis=0)
    return jnp.asarray(tot) if isinstance(x, jax.Array) else tot


def agree(tag: str, value: str):
    """Assert every process computed the same control-flow `value`
    (e.g. the check_files restore decision): divergent views would
    desynchronize the per-stage collectives into a silent deadlock, so
    turn them into an immediate error instead."""
    if jax.process_count() == 1:
        return value
    from jax.experimental import multihost_utils

    b = np.zeros(64, dtype=np.uint8)
    enc = value.encode()[:64]
    b[: len(enc)] = np.frombuffer(enc, dtype=np.uint8)
    allv = np.asarray(multihost_utils.process_allgather(b))
    if not (allv == allv[0]).all():
        raise RuntimeError(
            f"multi-process control-flow divergence at {tag!r}: processes "
            "disagree (is the run directory on a shared filesystem?)"
        )
    return value


def host_local_batch(mesh: Mesh, spec: P, value: np.ndarray):
    """Host numpy (identical on every process) -> global Array sharded by
    `spec` over `mesh`; each process supplies only the shards its local
    devices own."""
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(value, sharding)
    return jax.make_array_from_callback(
        np.shape(value), sharding, lambda idx: np.asarray(value)[idx]
    )
