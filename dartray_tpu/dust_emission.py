"""Dust temperature and emission: 'eff' and 'equ' heating modes.

Rebuild of the dust-emission core of sed_routines.f90:

* convert_ufield_ifield (sed:337-374): stellar radiation field energy
  density -> wavelength-space integrated intensity [W/m/m^2];
* calc_t_dust_equil + zbrent_tdust (sed:846-874, 994-1078): equilibrium
  grain temperature from absorbed = emitted; the scalar Brent solve per
  cell becomes a *batched bisection* over all cells at once (the balance
  function is monotonic in T, so bisection vectorizes over cells);
* calc_dens_dustem (sed:377-427): effective-grain emissivity
  4 pi kabs/kext_ref * dens_ref * B(T,lambda) [* parsec^2 -> W/m/pc^3];
* calc_dens_dustem_equ (sed:431-504): per-species/per-size equilibrium
  emission integrated over the grain size distributions.

The stochastic ('sto'/'sto_lib') modes live in sto.py (full P(T) solve,
Gaussian f(E) approximation, transition matrices as batched matmuls,
radiation-field binning for the sto_lib library mode).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .constants import CSPEED, HPLANCK, KBOLTZ, PARSEC

# full float32 products in the absorbed/emitted energy integrals: a GPU
# may otherwise run float32 einsums in TF32 (about three decimal digits)
_HIGHEST = jax.lax.Precision.HIGHEST

T_MIN, T_MAX = 0.0, 1.0e4  # zbrent bracket (sed_routines.f90:9-11)


def bplanck(T, lam_si):
    """Planck specific intensity B_lambda [W/m^2/m/sr] (bplanck, sed:939-948).
    Vectorized over both arguments (broadcasting)."""
    T = jnp.asarray(T)
    lam = jnp.asarray(lam_si)
    a1 = 2.0 * HPLANCK * CSPEED**2 / lam**5
    x = HPLANCK * CSPEED / (lam * KBOLTZ * jnp.maximum(T, 1e-30))
    # expm1 for numerical stability at small x; large x -> exp overflow guard
    return a1 / jnp.expm1(jnp.clip(x, 1e-10, 700.0))


def convert_ufield_ifield(u_stellar, lambda_si_stars, units_ufield="erg/Hz/pc^3"):
    """Stellar U (ncell, Ls) -> integrated intensity [W/m/m^2]
    (convert_ufield_ifield, sed_routines.f90:337-374)."""
    if units_ufield == "erg/Hz/pc^3":
        conv = PARSEC ** (-3) * CSPEED * 1e-7
    elif units_ufield == "J/Hz/pc^3":
        conv = PARSEC ** (-3) * CSPEED
    else:
        raise ValueError(f"unknown units_ufield {units_ufield!r}")
    rf = jnp.asarray(u_stellar) * conv  # W/Hz/m^2
    return rf * (CSPEED / jnp.asarray(lambda_si_stars) ** 2)[None, :]  # W/m/m^2


def absorbed_energy(kabs_stars, kabs_dust, rf_stars, rf_dust, dl_stars, dl_dust):
    """Absorbed power per grain [W] (calc_t_dust_equil, sed:855-863).

    kabs_* : (Ls,)/(Ld,) or (..., Ls)/(..., Ld) cross sections [m^2]
    rf_*   : (N, Ls)/(N, Ld) radiation fields [W/m/m^2]
    """
    a = jnp.sum(kabs_stars * rf_stars * dl_stars, axis=-1)
    if rf_dust is not None:
        a = a + jnp.sum(kabs_dust * rf_dust * dl_dust, axis=-1)
    return a


def emitted_energy(T, kabs_dust, lam_dust_si, dl_dust):
    """Emitted power per grain at temperature T [W]
    (abs_en_diff, sed:917-936): 4 pi sum kabs B(T) dlambda."""
    B = bplanck(T[..., None], lam_dust_si)  # (..., Ld)
    return 4.0 * jnp.pi * jnp.sum(kabs_dust * B * dl_dust, axis=-1)


def solve_t_equil(kabs_dust, lam_dust_si, dl_dust, abs_en, n_iter: int = 64):
    """Equilibrium temperature: emitted(T) = abs_en, batched bisection.

    emitted(T) is strictly increasing, so bisection on [T_MIN, T_MAX]
    converges to ~1e4 * 2^-64 — far below the reference's tol=1e-8.
    kabs_dust: (..., Ld) per-problem cross sections; abs_en: (...,).
    """
    lo = jnp.full(jnp.shape(abs_en), T_MIN, dtype=jnp.result_type(float))
    hi = jnp.full(jnp.shape(abs_en), T_MAX, dtype=jnp.result_type(float))

    def body(_, lohi):
        lo, hi = lohi
        mid = 0.5 * (lo + hi)
        em = emitted_energy(mid, kabs_dust, lam_dust_si, dl_dust)
        too_hot = em > abs_en
        return jnp.where(too_hot, lo, mid), jnp.where(too_hot, mid, hi)

    lo, hi = jax.lax.fori_loop(0, n_iter, body, (lo, hi))
    return 0.5 * (lo + hi)


def dens_dustem_eff(
    dust, wl, dens_ref, u_stellar, u_dust=None, units_ufield="erg/Hz/pc^3"
):
    """Effective-grain dust emissivity (calc_dens_dustem, sed:377-427).

    Returns (dens_stars_dust (ncell, Ld) [W/m/pc^3], T_dust (ncell,)).
    u_stellar: (ncell, Ls) stellar field in units_ufield;
    u_dust: (ncell, Ld) dust-emission field in J/m/pc^3 (or None).
    """
    sl_s = wl.stellar_slice
    sl_d = wl.dust_slice
    lam_d = jnp.asarray(wl.lambda_si[sl_d])
    dl_s = jnp.asarray(wl.delta_lambda_bin_stars)
    dl_d = jnp.asarray(wl.delta_lambda_bin_dust)
    kabs_s = jnp.asarray(dust.kabs[sl_s])
    kabs_d = jnp.asarray(dust.kabs[sl_d])

    rf_stars = convert_ufield_ifield(u_stellar, wl.lambda_si[sl_s], units_ufield)
    rf_dust = (
        jnp.asarray(u_dust) / PARSEC**3 * CSPEED if u_dust is not None else None
    )

    abs_en = absorbed_energy(kabs_s, kabs_d, rf_stars, rf_dust, dl_s, dl_d)
    T = solve_t_equil(kabs_d, lam_d, dl_d, abs_en)

    dref = jnp.asarray(dens_ref)
    B = bplanck(T[:, None], lam_d[None, :])  # (ncell, Ld)
    em = 4.0 * jnp.pi * kabs_d[None, :] / dust.kext_ref * dref[:, None] * B
    em = em * PARSEC**2  # set_units_dens_stars_arr (sed:903-914)
    em = jnp.where((dref > 0)[:, None], em, 0.0)
    T = jnp.where(dref > 0, T, 0.0)
    return em, T


def grain_absorbed(kabs_s_g, rf_s, dl_s, kabs_d_g=None, rf_d=None, dl_d=None):
    """Absorbed power per grain (n, C, A) from the stellar (and dust)
    radiation field: sum over lambda of kabs(a, lambda) rf(lambda) dlambda."""
    abs_en = jnp.einsum("cas,ns->nca", kabs_s_g, rf_s * dl_s[None, :],
                        precision=_HIGHEST)
    if rf_d is not None:
        abs_en = abs_en + jnp.einsum(
            "cad,nd->nca", kabs_d_g, rf_d * dl_d[None, :], precision=_HIGHEST)
    return abs_en


def grain_emission(B, kabs_d_g, wsize):
    """4 pi * integral over sizes of kabs(a) B(T(a)) f(a) da: (n, Ld)
    [W/m/H] from the per-grain Planck functions B (n, C, A, Ld)."""
    return 4.0 * jnp.pi * jnp.einsum(
        "ncad,cad,ca->nd", B, kabs_d_g, wsize, precision=_HIGHEST)


def dens_dustem_equ(
    dust, wl, dens_ref, u_stellar, u_dust=None, units_ufield="erg/Hz/pc^3",
    cell_batch: int = 2048,
):
    """Grain-mixture equilibrium emission (calc_dens_dustem_equ, sed:431-504):
    a temperature solve per (cell, species, grain size), integrated over the
    size distributions.  Returns (dens_stars_dust (ncell, Ld) [W/m/pc^3])."""
    if dust.qabs_fa is None:
        raise ValueError("'equ' heating requires grain-level dust tables")
    sl_s = wl.stellar_slice
    sl_d = wl.dust_slice
    lam_d = jnp.asarray(wl.lambda_si[sl_d])
    dl_s = jnp.asarray(wl.delta_lambda_bin_stars)
    dl_d = jnp.asarray(wl.delta_lambda_bin_dust)

    rf_stars_all = convert_ufield_ifield(u_stellar, wl.lambda_si[sl_s], units_ufield)
    rf_dust_all = (
        jnp.asarray(u_dust) / PARSEC**3 * CSPEED if u_dust is not None else None
    )

    C, A, _ = dust.qabs_fa.shape
    a2 = np.pi * dust.dust_size_fa**2  # (C, A) geometric cross sections
    kabs_s_g = jnp.asarray(a2[..., None] * dust.qabs_fa[:, :, sl_s])  # (C,A,Ls)
    kabs_d_g = jnp.asarray(a2[..., None] * dust.qabs_fa[:, :, sl_d])  # (C,A,Ld)
    # weights for the size integration: f(a) da, zero on padded sizes
    wsize = dust.dust_fa * dust.delta_dust_size  # (C, A)
    size_valid = np.arange(A)[None, :] < dust.n_dust_size[:, None]
    wsize = jnp.asarray(np.where(size_valid, wsize, 0.0))

    dref = np.asarray(dens_ref)
    sel = np.flatnonzero(dref > 0)
    out = np.zeros((len(dref), wl.lnum_dust))

    for b0 in range(0, len(sel), cell_batch):
        idx = sel[b0 : b0 + cell_batch]
        rf_s = rf_stars_all[idx]  # (n, Ls)
        rf_d = rf_dust_all[idx] if rf_dust_all is not None else None
        abs_en = grain_absorbed(kabs_s_g, rf_s, dl_s, kabs_d_g, rf_d, dl_d)
        T = solve_t_equil(
            kabs_d_g[None, :, :, :], lam_d, dl_d, abs_en
        )  # (n, C, A)
        B = bplanck(T[..., None], lam_d)  # (n, C, A, Ld)
        em = grain_emission(B, kabs_d_g, wsize)
        em = em / dust.tau_nh_ref * jnp.asarray(dref[idx])[:, None] * PARSEC**2
        out[idx] = np.asarray(em)
    return out
