"""Device-mesh sharding of the RT computation.

Replacement for the reference's MPI decomposition (SURVEY.md
§2.2): the grid and field accumulators are replicated, rays are sharded
across the mesh "rays" axis (P1 source-data parallelism), wavelengths can
be sharded across a second "wave" axis (P3 wavelength sharding), and the
per-stage reductions (P6/P7: reduce_u_fest_arr / reduce_u_final_arr,
io_routines.f90:3667-3986) become jax.lax.psum over the mesh — no
fine-grained en_sca messaging (P4/P5) is needed because deposits are
scatter-adds followed by a single all-reduce.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..grid.octree import Grid
from ..rt import march as M
from ..rt import replay as REP


def make_mesh(n_rays: int, n_wave: int = 1, devices=None):
    devs = np.array((devices or jax.devices())[: n_rays * n_wave]).reshape(
        n_rays, n_wave
    )
    return Mesh(devs, ("rays", "wave"))


def sharded_march_u(mesh: Mesh, grid: Grid, dens_ref, kext_norm, albedo, batch, **kw):
    """Data-parallel march: each device traces its shard of the ray batch
    into a local field accumulator; one psum over the 'rays' axis replaces
    the reference's reduce_u_*_arr collectives."""
    L = kext_norm.shape[0]
    fdtype = batch.lum.dtype
    u0 = jnp.zeros((grid.n_cells, L), dtype=fdtype)
    ufest = kw.pop("u_fest", u0)

    ray_specs = M.RayBatch(
        src_pos=P("rays"), src_cell=P("rays"), theta=P("rays"), phi=P("rays"),
        ipix=P("rays"), lum=P("rays", None), prev=P("rays"), cc_old=P("rays"),
        isel_old=P("rays"), fresh=P("rays"), seen_other=P("rays"),
        active=P("rays"),
    )

    def local(dens_ref, kext_norm, albedo, ufest, u0, b):
        u, res = M.march(grid, dens_ref, kext_norm, albedo, ufest, u0, b, **kw)
        u = jax.lax.psum(u, "rays")
        lost = jax.lax.psum(res.lum_lost, "rays")
        return u, lost

    f = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), ray_specs),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(f)(dens_ref, kext_norm, albedo, ufest, u0, batch)


def ray_mesh(n_devices: int = None, devices=None):
    """1-D mesh over the local devices for ray data parallelism (P1)."""
    devs = devices or jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), ("rays",))


_BATCH_SPECS = M.RayBatch(
    src_pos=P("rays"), src_cell=P("rays"), theta=P("rays"), phi=P("rays"),
    ipix=P("rays"), lum=P("rays", None), prev=P("rays"), cc_old=P("rays"),
    isel_old=P("rays"), fresh=P("rays"), seen_other=P("rays"),
    active=P("rays"),
)


def make_stage_march(mesh: Mesh, grid: Grid, n_buckets: int, **static_kw):
    """Sharded march for the production field stages (P1 + P6 + P3).

    Rays are split over the mesh 'rays' axis; every device accumulates
    deposits into its OWN full replica of the field (and scaspe) held as a
    device-sharded (ndev, ...) slab — the reference's no_communications
    mode (rt_routines.f90:319; reduce_* io_routines.f90:3667-3986).  No
    collective runs per round; the engine sums the slabs ONCE per stage
    (stage_reduce), which XLA lowers to a single all-reduce.

    When the mesh also has a 'wave' axis (P3, prepare_scaspe_splitting
    rt_routines.f90:2855-2965), the scaspe slabs' wavelength axis is
    sharded across it: every (rays, wave) device traces its ray shard over
    ALL wavelengths (the u math is identical across 'wave', exactly like
    the reference where every rank traces full-spectrum rays) but deposits
    only its local wavelength columns — per-device scaspe memory shrinks
    by the 'wave' size instead of being replicated.  The per-bucket
    wavelength tables (g, lam_idx, mask) are then passed per call, padded
    by the engine to a multiple of the 'wave' size.

    Returns fn(dens_ref, kext_norm, albedo, u_fest, u_slab, batch, beam_i,
    can_merge[, scaspe_slabs, scaspe_g, scaspe_lam_idx, scaspe_lam_mask])
    -> (u_slab', MarchResult[, scaspe_slabs']) where u_slab is
    (ndev, ncell, L) sharded on axis 0.
    """
    ndev = mesh.shape["rays"]
    has_wave = "wave" in mesh.axis_names and mesh.shape["wave"] > 1
    # per-wavelength scaspe tables travel as (sharded) call args, not as
    # replicated closure constants, when the wave axis is active
    static_kw = dict(static_kw)
    for k in ("scaspe_g", "scaspe_lam_idx", "scaspe_lam_mask"):
        static_kw.pop(k, None)

    def local(dens_ref, kext_norm, albedo, u_fest, u_slab, b, beam_i,
              can_merge, scaspe_slabs, sc_g, sc_idx, sc_mask):
        kw = static_kw
        if n_buckets:
            kw = dict(
                static_kw,
                scaspe_accum=tuple(s[0] for s in scaspe_slabs),
                scaspe_g=sc_g, scaspe_lam_idx=sc_idx,
                scaspe_lam_mask=sc_mask,
            )
        out = M.march(
            grid, dens_ref, kext_norm, albedo, u_fest, u_slab[0], b,
            beam_i=beam_i, allow_block=can_merge, **kw,
        )
        if n_buckets:
            u, res, scaspe = out
            sc_out = tuple(s[None] for s in scaspe)
        else:
            u, res = out
            sc_out = ()
        return (
            u[None], res.lum, res.packed_i, res.packed_f,
            res.n_steps[None], res.lum_lost[None], res.lum_esc[None],
        ) + sc_out

    lam_spec = P("wave") if has_wave else P()
    sc_specs = tuple(
        P("rays", None, None, "wave") if has_wave else P("rays")
        for _ in range(n_buckets)
    )
    lam_specs = tuple(lam_spec for _ in range(n_buckets))
    f = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P("rays"), _BATCH_SPECS, P("rays"),
                  P("rays"), sc_specs, lam_specs, lam_specs, lam_specs),
        out_specs=(P("rays"), P("rays", None), P(None, "rays"),
                   P(None, "rays"), P("rays"), P("rays"), P("rays"))
        + sc_specs,
        check_vma=False,
    )

    @jax.jit
    def run(dens_ref, kext_norm, albedo, u_fest, u_slab, batch, beam_i,
            can_merge, scaspe_slabs=(), scaspe_g=(), scaspe_lam_idx=(),
            scaspe_lam_mask=()):
        NR = batch.n
        if NR % ndev or NR // ndev < kext_norm.shape[0]:
            raise ValueError(
                f"batch of {NR} rays not shardable over {ndev} devices"
            )
        out = f(dens_ref, kext_norm, albedo, u_fest, u_slab, batch, beam_i,
                can_merge, scaspe_slabs, scaspe_g, scaspe_lam_idx,
                scaspe_lam_mask)
        u_slab2, lum, pi, pf, n_steps, lum_lost, lum_esc = out[:7]
        steps_tot = jnp.sum(n_steps)
        lost_tot = jnp.sum(lum_lost, axis=0)
        esc_tot = jnp.sum(lum_esc, axis=0)
        # re-establish the single-device packed layout: row 6 of packed_i =
        # total steps, rows 2-3 of packed_f = total lum_lost / lum_esc
        # (per-shard rows stitched along the ray axis leave per-shard
        # values there)
        pi = pi.at[6].set(steps_tot.astype(pi.dtype))
        # row 7 = per-shard loop iteration counts; report the slowest shard
        pi = pi.at[7].set(jnp.max(pi[7]))
        for row, tot in ((2, lost_tot), (3, esc_tot)):
            pf = pf.at[row].set(
                jnp.zeros((pf.shape[1],), pf.dtype).at[: tot.shape[0]].set(tot)
            )
        packed_all = (
            jnp.concatenate([pi, jax.lax.bitcast_convert_type(pf, jnp.int32)])
            if pf.dtype == jnp.float32 else None
        )
        res = M.MarchResult(
            status=pi[0], lum=lum, prev=pf[0], cc=pi[1], isel_old=pi[2],
            dplane=pf[1], lum_lost=lost_tot, i_obs=None, n_steps=steps_tot,
            lum_esc=esc_tot, cc_cur=pi[3], isel_cur=pi[4], seen_other=pi[5],
            packed_i=pi, packed_f=pf, packed_all=packed_all,
        )
        if n_buckets:
            return u_slab2, res, out[7:]
        return u_slab2, res

    return run


def stage_reduce(slab):
    """Sum the per-device accumulator slab (ndev, ...) -> (...): the ONE
    per-stage collective (reduce_u_final_arr etc., io_routines.f90:3667)."""
    return jax.jit(lambda s: jnp.sum(s, axis=0))(slab)


def sharded_train_step(mesh: Mesh, grid: Grid, cs: float):
    """A full sharded 'training step': replayed field deposits +
    gradient of a field-matching loss w.r.t. the dust density, with rays
    sharded over the 'rays' axis and wavelengths over 'wave'.

    The gradient all-reduce (psum over 'rays') stands in for the
    reference's parameter-reduction collectives.
    Returns a jitted function
        step(dens_ref, kext_norm, lum, cells, lengths, count, src_cell,
             csize_nc, beam_i, u_target) -> (loss, grad_dens)
    """
    lvl = jnp.asarray(grid.lvl)
    cls = jnp.asarray(grid.csize_levels())

    def local(dens_ref, kext_norm, lum, cells, lengths, count, src_cell, csize_nc, beam_i, u_target):
        def loss_fn(dens):
            u = REP.replay_field(
                dens, kext_norm, lum, cells, lengths, count, src_cell,
                csize_nc, lvl, cls, beam_i, cs,
                n_cells=grid.n_cells, point_source=False,
            )
            # local shard loss; u_target is sharded over 'wave'
            return jnp.sum((u - u_target) ** 2)

        loss, grad = jax.value_and_grad(loss_fn)(dens_ref)
        # P7-equivalent reductions: sum loss/grad over both mesh axes
        loss = jax.lax.psum(loss, ("rays", "wave"))
        grad = jax.lax.psum(grad, ("rays", "wave"))
        return loss, grad

    f = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(),  # dens_ref: replicated
            P("wave"),  # kext_norm: wavelength-sharded (P3)
            P("rays", "wave"),  # lum
            P("rays", None),  # trace cells
            P("rays", None),  # trace lengths
            P("rays"),  # count
            P("rays"),  # src_cell
            P("rays"),  # csize_nc
            P("rays"),  # beam_i
            P(None, "wave"),  # u_target
        ),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(f)
