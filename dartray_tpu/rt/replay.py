"""Differentiable replay of recorded ray traces.

The march kernel (rt.march) is a data-dependent while_loop — not reverse-
differentiable.  Differentiability comes from a two-phase design instead
(SURVEY.md §7 design rule 4): the march records, per ray, the sequence of
(cell, intersection length) pairs; the *physics* along a fixed trace is a
closed-form product of per-step transmissions, evaluated here as dense
(NR, S, L) tensor math that JAX reverse-differentiates w.r.t. the dust
density field, the opacity curves and the source luminosities.  Ray
geometry (which cells, which splits, which kill decisions) is treated as
non-differentiable structure, like straight-through sampling.

The per-step factors reproduce deposit() exactly (rt_routines.f90:2362-2557):
  transmission    e^{-tau},   own cell: (1-e^{-tau_own})/tau_own
  mean intensity  I (1-e^{-tau})/tau,  own cell (homogeneous):
                  I (e^{-t}+t-1)/t^2,  own cell (point source): as external
  energy density  += i_av * length / cs / V * area_i * beam_i
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..grid.octree import Grid
from .march import exp_tau_minus_one, one_minus_exp


def _safe(tau, small):
    return jnp.where(small, 1.0, tau)


@partial(jax.jit, static_argnames=("point_source", "own_full_cell"))
def replay_iobs(
    dens_ref,  # (ncell,)
    kext_norm,  # (L,)
    init_lum,  # (NR, L) launch luminosity
    trace_cells,  # (NR, S) int32
    trace_lengths,  # (NR, S)
    trace_count,  # (NR,)
    src_cell,  # (NR,)
    csize_nc,  # (NR,) source-cell size
    *,
    point_source: bool = False,
    own_full_cell: bool = True,  # iobs modes use the full-cell own factor
):
    """Exit intensity of each ray: I0 * prod_s T_s.  Differentiable."""
    NR, S = trace_cells.shape
    L = kext_norm.shape[0]
    steps = jnp.arange(S)[None, :]
    valid = steps < trace_count[:, None]  # (NR, S)

    cells = jnp.clip(trace_cells, 0, dens_ref.shape[0] - 1)
    dref = dens_ref[cells]  # (NR, S)
    tau = dref[..., None] * kext_norm[None, None, :] * trace_lengths[..., None]
    small = tau < 1e-8
    T_ext = jnp.exp(-tau)

    is_own = (trace_cells == src_cell[:, None])[..., None]
    if own_full_cell:
        # iobs modes always use the full-cell homogeneous own factor,
        # including for point sources (deposit rt_routines.f90:2409-2411
        # only special-cases rtt_precalc_src / rtt_dir_src)
        tau_o = dref[..., None] * kext_norm[None, None, :] * csize_nc[:, None, None]
    else:
        tau_o = tau
    small_o = tau_o < 1e-8
    T_own = jnp.where(small_o, 1.0, one_minus_exp(tau_o) / _safe(tau_o, small_o))

    T = jnp.where(is_own, T_own, T_ext)
    T = jnp.where(valid[..., None], T, 1.0)
    I0 = init_lum / (4.0 * jnp.pi * csize_nc**2)[:, None]
    return I0 * jnp.prod(T, axis=1)  # (NR, L)


def hg_ffn(theta, phi, gsca_k, dirs_k, npix_hp: int):
    """Henyey-Greenstein deposition weights for one scaspe bucket,
    differentiable w.r.t. the asymmetry parameter (calc_ffn_arr,
    rt_routines.f90:2186-2281): (NR, P, L_k), normalized over the npix_hp
    HEALPix pixels."""
    st = jnp.sin(theta)
    d = jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), jnp.cos(theta)], -1)
    if npix_hp <= 1:
        return jnp.ones((theta.shape[0], dirs_k.shape[0], gsca_k.shape[0]),
                        dtype=d.dtype)
    # full float32 products: a TF32 cosine would move the g ~ 0.6 HG
    # weights by far more than the replay's tolerance
    ads = jnp.matmul(d, dirs_k.T, precision=jax.lax.Precision.HIGHEST)
    g = gsca_k[None, None, :]
    w = (1.0 - g**2) / npix_hp * (1.0 + g**2 - 2.0 * g * ads[:, :, None]) ** (-1.5)
    tot = jnp.sum(w[:, :npix_hp, :], axis=1, keepdims=True)
    return w / jnp.maximum(tot, 1e-300)


@partial(jax.jit, static_argnames=("point_source", "n_cells", "npix_hp"))
def replay_scaspe(
    dens_ref,  # (ncell,)
    kext_norm,  # (L,)
    albedo,  # (L,)
    gsca,  # (L,)
    init_lum,  # (NR, L)
    trace_cells,  # (NR, S)
    trace_lengths,
    trace_count,
    src_cell,
    csize_nc,
    theta,  # (NR,) ray directions (for the HG weights)
    phi,
    beam_i,  # () or (NR,)
    bucket_dirs: tuple,  # per-bucket (P_k, 3) scaspe direction unit vectors
    bucket_lam_idx: tuple,  # per-bucket (L_k,) wavelength indices
    *,
    npix_hp: tuple,  # per-bucket HEALPix pixel count (static)
    n_cells: int,
    point_source: bool = False,
):
    """Scattering-source-function deposits along recorded traces,
    differentiable w.r.t. dens/kext/albedo/gsca.

    Reproduces the march's en_sca deposits (process_scatt_rad,
    rt_routines.f90:2638-2726; en_sca formulas deposit :2399-2427):
      external cell:  en = I (1 - e^{-tau}) albedo area_i beam_i
      own cell (ps):  en = I/tau (e^{-tau} + tau - 1) ...
      own cell (cell src, full-cell tau_o): en = I/tau_o (e^{-tau_o}+tau_o-1)
    each distributed over the bucket directions with HG weights.
    Returns a per-bucket tuple of (ncell, P_k, L_k).
    """
    NR, S = trace_cells.shape
    L = kext_norm.shape[0]
    steps = jnp.arange(S)[None, :]
    valid = steps < trace_count[:, None]

    cells = jnp.clip(trace_cells, 0, n_cells - 1)
    dref = dens_ref[cells]
    tau = dref[..., None] * kext_norm[None, None, :] * trace_lengths[..., None]
    small = tau < 1e-8
    exp_tau = jnp.exp(-tau)

    is_own = (trace_cells == src_cell[:, None])[..., None]
    if point_source:
        tau_o, small_o = tau, small
    else:
        tau_o = dref[..., None] * kext_norm[None, None, :] * csize_nc[:, None, None]
        small_o = tau_o < 1e-8

    T_ext = exp_tau
    T_own = jnp.where(small_o, 1.0, one_minus_exp(tau_o) / _safe(tau_o, small_o))
    T = jnp.where(is_own, T_own, T_ext)
    T = jnp.where(valid[..., None], T, 1.0)
    I0 = init_lum / (4.0 * jnp.pi * csize_nc**2)[:, None]
    cum = jnp.cumprod(T, axis=1)
    I_entry = jnp.concatenate(
        [jnp.broadcast_to(I0[:, None, :], (NR, 1, L)), I0[:, None, :] * cum[:, :-1, :]],
        axis=1,
    )

    en_ext = jnp.where(small, I_entry * tau, I_entry * one_minus_exp(tau))
    en_own = jnp.where(
        small_o,
        I_entry * tau_o / 2.0,
        I_entry / _safe(tau_o, small_o) * exp_tau_minus_one(tau_o),
    )
    en = jnp.where(is_own, en_own, en_ext)
    beam_i = jnp.broadcast_to(jnp.asarray(beam_i), (NR,))
    en = en * albedo[None, None, :] * (csize_nc**2 * beam_i)[:, None, None]
    en = jnp.where(valid[..., None], en, 0.0)  # (NR, S, L)

    out = []
    for dirs_k, lam_idx_k, nhp_k in zip(bucket_dirs, bucket_lam_idx, npix_hp):
        ffn = hg_ffn(theta, phi, gsca[lam_idx_k], dirs_k, nhp_k)  # (NR,P,Lk)
        dep = ffn[:, None, :, :] * jnp.take(en, lam_idx_k, axis=2)[:, :, None, :]
        P = dirs_k.shape[0]
        Lk = lam_idx_k.shape[0]
        sc = jnp.zeros((n_cells, P, Lk), dtype=dep.dtype)
        sc = sc.at[cells.reshape(-1)].add(dep.reshape(-1, P, Lk))
        out.append(sc)
    return tuple(out)


def scattered_src_lum(scaspe: tuple, cells, pix_per_bucket, bucket_lam_idx,
                      npix_hp, L: int):
    """Scattered-light launch luminosity for rays re-emitting a cell's
    scaspe toward their own direction (assign_src_lum,
    rt_routines.f90:3043-3071): scaspe[cell, pix(dir)] * npix_hp.
    Differentiable in scaspe — the coupling term that chains one
    scattering iteration's deposits into the next iteration's sources
    (the rtt_scatt loop, dartray_hub.f90:45-52)."""
    out = jnp.zeros((len(cells), L), dtype=scaspe[0].dtype)
    for s, pix_k, lam_idx_k, nhp_k in zip(
        scaspe, pix_per_bucket, bucket_lam_idx, npix_hp
    ):
        out = out.at[:, lam_idx_k].set(s[cells, pix_k, :] * nhp_k)
    return out


def scattered_obs_lum(scaspe: tuple, cells, obs_col: int, bucket_lam_idx,
                      npix_hp, L: int):
    """Scattered-light launch luminosity toward appended observer column
    `obs_col` for each cell (rt_loop_iobs source, rt_routines.f90:1519-1548):
    scaspe[cell, npix_hp + j] * npix_hp.  Differentiable in scaspe."""
    parts = []
    for s, lam_idx_k, nhp_k in zip(scaspe, bucket_lam_idx, npix_hp):
        parts.append((s[cells, nhp_k + obs_col, :] * nhp_k, lam_idx_k))
    out = jnp.zeros((len(cells), L), dtype=scaspe[0].dtype)
    for vals, lam_idx_k in parts:
        out = out.at[:, lam_idx_k].set(vals)
    return out


@partial(jax.jit, static_argnames=("point_source", "n_cells"))
def replay_field(
    dens_ref,
    kext_norm,
    init_lum,
    trace_cells,
    trace_lengths,
    trace_count,
    src_cell,
    csize_nc,
    lvl_of_cell,  # (ncell,) levels for volume factors
    csize_levels,  # (max_lvl+1,)
    beam_i,  # () or (NR,)
    cs: float,
    *,
    n_cells: int,
    point_source: bool = False,
):
    """Radiation-field deposits along the recorded traces, differentiable.

    Returns u (ncell, L).  Matches the march deposits for the same traces.
    """
    NR, S = trace_cells.shape
    L = kext_norm.shape[0]
    steps = jnp.arange(S)[None, :]
    valid = steps < trace_count[:, None]

    cells = jnp.clip(trace_cells, 0, n_cells - 1)
    dref = dens_ref[cells]
    lengths = trace_lengths
    tau = dref[..., None] * kext_norm[None, None, :] * lengths[..., None]
    small = tau < 1e-8
    exp_tau = jnp.exp(-tau)

    is_own = (trace_cells == src_cell[:, None])[..., None]
    if point_source:
        tau_o, small_o = tau, small
    else:
        tau_o = dref[..., None] * kext_norm[None, None, :] * csize_nc[:, None, None]
        small_o = tau_o < 1e-8

    # per-step transmissions (for the running intensity)
    T_ext = exp_tau
    T_own = jnp.where(small_o, 1.0, one_minus_exp(tau_o) / _safe(tau_o, small_o))
    T = jnp.where(is_own, T_own, T_ext)
    T = jnp.where(valid[..., None], T, 1.0)

    I0 = init_lum / (4.0 * jnp.pi * csize_nc**2)[:, None]  # (NR, L)
    # intensity at the *entry* of each step: I0 * cumprod(T)[s-1]
    cum = jnp.cumprod(T, axis=1)
    I_entry = jnp.concatenate(
        [jnp.broadcast_to(I0[:, None, :], (NR, 1, L)), I0[:, None, :] * cum[:, :-1, :]],
        axis=1,
    )

    # mean intensity over the crossing
    i_av_ext = jnp.where(
        small, I_entry, I_entry / _safe(tau, small) * one_minus_exp(tau)
    )
    if point_source:
        i_av_own = i_av_ext
    else:
        i_av_own = jnp.where(
            small_o,
            I_entry,
            I_entry / _safe(tau_o, small_o) ** 2 * exp_tau_minus_one(tau_o),
        )
    i_av = jnp.where(is_own, i_av_own, i_av_ext)

    area_i = (csize_nc**2)[:, None, None]
    csize_c = csize_levels[lvl_of_cell[cells]]  # (NR, S)
    vol_f = (csize_c**3)[..., None]
    beam_i = jnp.broadcast_to(jnp.asarray(beam_i), (NR,))
    du = i_av * lengths[..., None] / cs / vol_f * area_i * beam_i[:, None, None]
    du = jnp.where(valid[..., None], du, 0.0)

    u = jnp.zeros((n_cells, L), dtype=du.dtype)
    u = u.at[cells.reshape(-1)].add(du.reshape(-1, L))
    return u
