"""TRUST I slab benchmark model.

Uniform dust slab z in [-5, -2] pc inside a 10 pc box, illuminated by a
single T = 10^4 K blackbody point source of 100,000 Lsun at (0, 0, 4) pc
(user_routines_trustI.f90:15-19).  This is the standard RT benchmark
(Gordon et al.) and the headline perf workload (BASELINE.md).
"""
from __future__ import annotations

import numpy as np

from ..constants import PARSEC
from ..grid.builder import build_grid

# slab geometry [pc] (user_routines_trustI.f90:15-19)
Z0_SLAB, Z1_SLAB = -5.0, -2.0
X0_SLAB, X1_SLAB = -5.0, 5.0
Y0_SLAB, Y1_SLAB = -5.0, 5.0
LZ_SLAB = 3.0
STAR_POS = np.array([0.0, 0.0, 4.0])


def slab_extinction(tau_z: float, kext_ref_m2: float):
    """Extinction coefficient [1/pc] inside the slab for vertical optical
    depth tau_z at the reference wavelength (set_slab_density,
    user_routines_trustI.f90:78-89)."""
    # kext_ref in m^2/grain -> pc^2; ndust = tau/(kext*Lz) [pc^-3]; the grid
    # stores ndust*kext = extinction coefficient [pc^-1]
    return tau_z / LZ_SLAB


def make_dens_fn(tau_z: float):
    """Cell-averaged extinction coefficient for the slab.

    Cells are axis-aligned, the slab is axis-aligned: the exact volume
    fraction is a product of 1D overlaps (the reference samples with
    nstep=1, av_rho_dust_slab user_routines_trustI.f90:167-221 — i.e. it
    uses the *center* value; we keep center sampling for parity).
    """
    ndust = slab_extinction(tau_z, 0.0)

    def dens_fn(centers, csize):
        x, y, z = centers[:, 0], centers[:, 1], centers[:, 2]
        inside = (
            (z >= Z0_SLAB) & (z <= Z1_SLAB)
            & (x >= X0_SLAB) & (x <= X1_SLAB)
            & (y >= Y0_SLAB) & (y <= Y1_SLAB)
        )
        dens = np.where(inside, ndust, 0.0)
        dens_stars = np.zeros_like(dens)
        return dens, dens_stars

    return dens_fn


def make_subdivision_fn(max_dtau: float, min_lvl_in: int, max_lvl: int):
    """'standard' subdivision criterion (create_adap_grid_trustI.f90:86-94):
    subdivide while level < max_lvl AND (cell top face on the slab top
    OR (tau > max_dtau AND level < min_lvl_in))."""

    def subdivision_fn(centers, csize, level, dens, dens_stars):
        z = centers[:, 2]
        tau = dens * csize
        top_on_slab = np.abs(z + csize / 2.0 - Z1_SLAB) / abs(Z1_SLAB) < 1e-5
        return (level < max_lvl) & (
            top_on_slab | ((tau > max_dtau) & (level < min_lvl_in))
        )

    return subdivision_fn


def build_trustI_grid(
    tau_z: float = 0.01,
    base=(10, 2),
    max_lvl: int = 4,
    min_lvl: int = 1,
    min_lvl_in: int = 10,
    max_dtau: float = 1e-4,
    modelsize: float = 10.0,
    max_ncell: int = 4_000_000,
):
    """Create the TRUST I adaptive grid (input_grid_trustI_tau0.01_LD.in)."""
    return build_grid(
        make_dens_fn(tau_z),
        make_subdivision_fn(max_dtau, min_lvl_in, max_lvl),
        base=base,
        max_lvl=max_lvl,
        min_lvl=min_lvl,
        modelsize=modelsize,
        max_ncell=max_ncell,
    )


def read_planck_table(path: str):
    """Load the BB_T10000_L100000.dat source SED table.

    Returns (lambda_um, lum_erg_s_hz); log-log interpolation to arbitrary
    wavelengths is done by ``source_luminosity``
    (read_planck_table_trustI, user_routines_trustI.f90:91-165).
    """
    data = np.loadtxt(path, skiprows=6)
    return data[:, 0], data[:, 1]


def source_luminosity(lambda_um, table_lambda, table_lum):
    """Point-source luminosity [erg/s/Hz] at given wavelengths, log-log
    linearly interpolated from the blackbody table."""
    lam = np.atleast_1d(np.asarray(lambda_um, dtype=np.float64))
    if lam.min() < table_lambda[0] or lam.max() > table_lambda[-1]:
        raise ValueError("lambda outside tabulated blackbody range")
    return 10.0 ** np.interp(
        np.log10(lam), np.log10(table_lambda), np.log10(table_lum)
    )


def single_scattering_flux_jy(kext_norm, albedo, gsca, lum_l, scfg,
                              tau_z: float, up: bool, dist_pc: float):
    """Closed-form first-order scattered flux [Jy] toward a vertical
    external observer (up: +z, else -z) at dist_pc, by numerical
    quadrature over the slab:

        F_1(n) d^2 = int dV rho k_sca [L e^{-tau_in} / (4 pi r^2)]
                     Phi(s, n) / (4 pi) e^{-tau_out}

    with s the direction source -> x, tau_in / tau_out the slab optical
    depths along the in / out paths (closed form for a z-slab), and Phi
    the Henyey-Greenstein phase factor in the framework's *discrete*
    normalization (calc_ffn_arr, rt_routines.f90:2186-2281): w(cos a) *
    npix_hp / sum_p w(cos a_p) over the bucket's HEALPix pixel directions
    of ``scfg`` (an rt.scattering.ScaspeConfig), which removes the
    angular-discretization term from a comparison with the framework.
    ``kext_norm`` (kext / kext_ref), ``albedo``, ``gsca`` and ``lum_l``
    (the star's luminosity [erg/s/Hz]) cover the wavelengths of
    ``scfg``."""
    z_top, z_bot = Z1_SLAB, Z1_SLAB - LZ_SLAB
    S = STAR_POS
    # the integrand is smooth: the source is 6 pc above the slab top
    nx, nz = 60, 48
    xs = np.linspace(-5, 5, nx, endpoint=False) + 5.0 / nx
    zs = np.linspace(z_bot, z_top, nz, endpoint=False) + (
        (z_top - z_bot) / nz / 2
    )
    X, Y, Z = np.meshgrid(xs, xs, zs, indexing="ij")
    dV = (10.0 / nx) ** 2 * ((z_top - z_bot) / nz)
    P3 = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1)  # (N, 3)
    r = np.linalg.norm(P3 - S, axis=1)
    s_hat = (P3 - S) / r[:, None]
    cosa = s_hat[:, 2] if up else -s_hat[:, 2]

    k_ref = tau_z / LZ_SLAB  # extinction coefficient at lambda_ref [1/pc]
    out = np.zeros(scfg.L)
    for il, (kn, alb, g) in enumerate(
        zip(np.asarray(kext_norm), np.asarray(albedo), np.asarray(gsca))
    ):
        k = k_ref * kn
        tau_in = k * r * (z_top - P3[:, 2]) / (S[2] - P3[:, 2])
        tau_out = k * ((z_top - P3[:, 2]) if up else (P3[:, 2] - z_bot))
        b = next(bb for bb in scfg.buckets
                 if il in set(bb.lam_idx.tolist()))
        if b.kp >= 0:
            dirs = b.dirs[: b.npix_hp]  # (P, 3) HEALPix pixel centers
            wpix = (1 - g**2) * (
                1 + g**2 - 2 * g * (s_hat @ dirs.T)
            ) ** -1.5  # (N, P)
            wobs = (1 - g**2) * (1 + g**2 - 2 * g * cosa) ** -1.5
            phi = wobs / wpix.sum(axis=1) * b.npix_hp
        else:
            phi = np.ones_like(cosa)
        integ = (
            k * alb * lum_l[il] * np.exp(-tau_in) / (4 * np.pi * r**2)
            * phi / (4 * np.pi) * np.exp(-tau_out)
        )
        out[il] = integ.sum() * dV
    d_cm = dist_pc * PARSEC * 100
    return out / (d_cm**2) * 1e23
