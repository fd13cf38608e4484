"""Stochastic dust heating: the 'sto' and 'sto_lib' dust-emission modes.

Rebuild of the stochastically-heated-emission machinery of
sed_routines.f90 (calc_dens_dustem_sto 548, calc_dens_dustem_sto_lib 673,
calc_gaussian_fE 2089, calc_full_fE 2186, calc_rd_arr 877,
calc_integrals_photon_abs_rate 2503, calc_transition_matrices 2561,
calc_Edot_arr 2600, calc_dosage_function_moment_integrals 2616,
bin_rad_field 2925), after Guhathakurta & Draine 1989 and Voit 1991.

Design (vs the reference's triple nested cell/species/size scalar loops):

* every (problem, species, grain-size) triple becomes one row of a flat
  "grain batch"; all per-grain physics (equilibrium T, dosage moments,
  Gaussian f(E)) is vectorized over the batch;
* the level recursion of the full Guhathakurta-Draine solve (inherently
  sequential over the n_temp_pt enthalpy levels) is a single
  ``lax.scan`` over levels, ``vmap``-ed over grains, so the per-level
  dot products against the transition-matrix rows batch across grains;
* the transition matrices AA/BB are never materialized (300x300 per
  grain): each scan step evaluates its row on the fly from the
  integrated photon-absorption-rate table (calc_transition_matrices
  does the same thing with an explicit matrix);
* the reference's "iterate until the temperature range covers the
  distribution" outer loop becomes a fixed-count masked loop.

A "problem" is one radiation-field spectrum: a grid cell ('sto') or an
adaptive-library bin ('sto_lib', Natale et al. 2015).

Deliberate divergences (documented):
* the UV/optical binning integrals in bin_rad_field use a trapezoid
  integral; the reference divides by the wavelength spacing instead of
  multiplying (sed:2956-2958) - any monotone measure of the field only
  changes *which* cells share a library bin, not the physics;
* interpolations of the integrated photon rate clamp at >= 0 (the
  reference's linear extrapolation can go negative beyond the table);
* Tmin/Tmax for the full solve always start from the grain's own
  Gaussian-width estimate instead of carrying the previous grain's
  range (tmin_prev/tmax_prev, sed:611-613) - the range-expansion loop
  makes both converge to the same support.
"""
from __future__ import annotations

import contextlib
import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .constants import PARSEC, CSPEED, HPLANCK, SIGMA_SB
from .dust_emission import bplanck, convert_ufield_ifield, solve_t_equil

N_TEMP_PT = 300  # enthalpy/temperature levels (sed_routines.f90:50)
N_TEMP_SUB = 50  # Voit subgrid points (calc_full_fE, sed:2215)
N_DELTA_E = 100  # dosage-moment fine grid (sed:2621)


def _f64_context():
    """Force float64 for the stochastic solve.

    The full P(T) solve is not float32-viable: Rd2 moments
    (~(1e-19 J)^2/s = 1e-38) sit below the smallest f32 normal, the
    enthalpy-squared terms underflow, and the exp() exponents exceed the
    f32 range.  When the session runs in f32 (the production default on
    the GPU), enable x64 for the solve; it stays on the default device,
    which computes in float64.  When x64 is already on (the test/CPU
    environment) this is a no-op.
    """
    if jax.config.jax_enable_x64:
        return contextlib.nullcontext()
    return jax.enable_x64(True)


# ---------------------------------------------------------------------------
# small numerics shared with the reference (value_locate + lin_interpolate)
# ---------------------------------------------------------------------------

def interp_extrap(x, xp, fp):
    """Linear interpolation with *linear extrapolation* at both ends,
    matching value_locate + lin_interpolate (sed:1663-1756).  xp ascending."""
    j = jnp.clip(jnp.searchsorted(xp, x), 1, len(xp) - 1)
    x0, x1 = xp[j - 1], xp[j]
    y0, y1 = fp[j - 1], fp[j]
    return y0 + (y1 - y0) * (x - x0) / (x1 - x0)


def bin_slope(x, xp, fp):
    """Slope of the table bin containing x (used for dQp/dT, sed:2148)."""
    j = jnp.clip(jnp.searchsorted(xp, x), 1, len(xp) - 1)
    return (fp[j] - fp[j - 1]) / (xp[j] - xp[j - 1])


def make_log_array(xmin, xmax, n):
    """Log-spaced array (make_log_array, sed:2416-2433); xmin/xmax may be
    batched — output shape (..., n)."""
    lx0 = jnp.log10(xmin)
    lx1 = jnp.log10(xmax)
    t = jnp.arange(n) / (n - 1)
    return 10.0 ** (lx0[..., None] + (lx1 - lx0)[..., None] * t)


def make_delta_array(xarr):
    """Integration bin widths from log-midpoints (make_delta_array,
    sed:2435-2458).  xarr (..., n) ascending."""
    mid = 10.0 ** ((jnp.log10(xarr[..., 1:]) + jnp.log10(xarr[..., :-1])) / 2.0)
    first = mid[..., :1] - xarr[..., :1]
    inner = mid[..., 1:] - mid[..., :-1]
    last = xarr[..., -1:] - mid[..., -1:]
    return jnp.concatenate([first, inner, last], axis=-1)


# ---------------------------------------------------------------------------
# full stochastic solve (Guhathakurta & Draine 1989 + Voit 1991)
# ---------------------------------------------------------------------------

def _interp_rd(x, rd_x, rd_y):
    """Integrated photon-absorption rate at transition energy x [J]:
    photons/s absorbed with photon energy >= x.  rd_x ascending photon
    energy (the reference interpolates the reversed array,
    interpolate_Rd_integrated sed:2699-2723); clamped at >= 0."""
    return jnp.maximum(interp_extrap(x, rd_x, rd_y), 0.0)


def _solve_pt_full(a, eT_x, eT_y, qp_x, qp_y, rd_x, rd_y, rd0, rd2,
                   t_eq, sigT, eph_max, n, n_sub, n_range_iter, big):
    """Temperature probability distribution P(T) for ONE grain by the
    numerical method of Guhathakurta & Draine 1989 with the analytical
    bin corrections of Voit 1991 (calc_full_fE, sed:2186-2413).

    a: grain radius [m]; (eT_x, eT_y): enthalpy table T [K] -> E [J]
    (already scaled by grain volume); (qp_x, qp_y): Planck-averaged Qabs
    table; (rd_x, rd_y): integrated photon-rate table (ascending photon
    energy); rd0/rd2: dosage-function moments; t_eq/sigT: equilibrium
    temperature and Gaussian width (starting range).
    Returns (pt (n,), T_arr (n,)).  vmap-ed over grains by the caller.
    """
    jidx = jnp.arange(n)

    tiny = jnp.finfo(eT_y.dtype).tiny

    def compute_pt(tmin, tmax):
        T_arr = make_log_array(tmin, tmax, n)
        E_arr = interp_extrap(T_arr, eT_x, eT_y)
        # clamp at > 0: linear extrapolation of the Planck-averaged Qabs
        # below the table start can go negative, which would flip the sign
        # of the cooling rate and poison the level recursion through
        # bb_diag (the reference instead skips leading levels until
        # bb(is-1,is) > 0, calc_full_fE sed:2307-2310)
        qp = jnp.maximum(interp_extrap(T_arr, qp_x, qp_y), tiny)
        # cooling rate at each level (calc_Edot_arr, sed:2600-2614)
        Edot = 4.0 * jnp.pi * a**2 * SIGMA_SB * qp * T_arr**4
        # dosage-function moment integrals on a fine transition-energy grid
        # (calc_dosage_function_moment_integrals, sed:2616-2680)
        dE_lvl = jnp.concatenate([jnp.zeros(1), E_arr[1:] - E_arr[:-1]])
        # keep the eps grid ascending even when every enthalpy bin is
        # narrower than the 0.01e-19 J lower anchor (smallest PAH grains on
        # a cool narrow T range): interp_extrap assumes ascending xp
        eps_max = jnp.maximum(jnp.max(dE_lvl), 0.01e-19 * 10.0)
        eps = make_log_array(jnp.asarray(0.01e-19), eps_max, N_DELTA_E)
        eps = eps.at[0].set(0.0)
        rdI_e = _interp_rd(eps, rd_x, rd_y)
        dosage = jnp.concatenate([jnp.zeros(1), rdI_e[:-1] - rdI_e[1:]])
        Re0 = interp_extrap(dE_lvl, eps, jnp.cumsum(dosage))
        Re1 = interp_extrap(dE_lvl, eps, jnp.cumsum(dosage * jnp.roll(eps, 1)))
        Re2 = interp_extrap(dE_lvl, eps, jnp.cumsum(dosage * jnp.roll(eps, 1) ** 2))

        # per-level coefficients of the analytic bin solution
        # (calc_full_fE, sed:2290-2306); level i uses Re*(i), Edot(i+1)
        Edot_n = jnp.concatenate([Edot[1:], Edot[-1:]])  # Edot(i+1) at slot i
        cond = Re2 / jnp.maximum(rd2, tiny) > 1e-6
        Re2s = jnp.where(cond, Re2, 1.0)
        a1 = (Edot_n - Re1) / (Re2s / 2.0)
        b1 = -(rd0 - Re0) / (Re2s / 2.0)
        c1 = 2.0 / Re2s
        disc = jnp.sqrt(jnp.maximum(0.25 * a1**2 - b1, 0.0))
        l1a = -0.5 * a1 + disc
        l2a = -0.5 * a1 - disc
        l1b = rd0 / jnp.maximum(Edot_n, tiny)

        E_next = jnp.concatenate([E_arr[1:], E_arr[-1:]])

        def body(pt, xs):
            (i, E_ip1, E_i, E_im1, Edot_i, cond_i,
             b1_i, c1_i, l1a_i, l2a_i, l1b_i, Re1_i, Re2_i) = xs
            pt = jnp.maximum(pt, 0.0)  # pt(i-1)<0 -> 0 (sed:2310)
            bb_diag = Edot_i / jnp.maximum(E_i - E_im1, tiny)
            maskj = jidx < i
            # transition-matrix row on the fly (calc_transition_matrices)
            rdv = _interp_rd(E_ip1 - E_arr, rd_x, rd_y)       # j = 0..n-1
            rdv1 = jnp.concatenate([rdv[1:], rdv[-1:]])        # rdv(j+1)
            # first approximation, GD89 / Voit eq. 49 (sed:2313)
            first = jnp.sum(jnp.where(maskj, rdv1 * pt, 0.0)) / bb_diag
            # source function Se(E), Voit eq. 53 (sed:2318)
            denom = jnp.where(E_next > E_arr, E_next - E_arr, 1.0)
            aa = (rdv1 - rdv) / denom
            SeE = jnp.sum(jnp.where(maskj, pt * aa, 0.0))
            # analytic solution on the subgrid [E(i-1), E(i)] (Voit eq. 52)
            pt_im1 = pt[i - 1]
            Es = E_im1 + (E_i - E_im1) * jnp.arange(n_sub) / (n_sub - 1)
            dEi = jnp.maximum(E_i - E_im1, tiny)
            ff = c1_i * (first * bb_diag + dEi * SeE
                         + (Re1_i - Edot_i) * pt_im1 / dEi)
            C2 = jnp.where(b1_i != 0, -c1_i / jnp.where(b1_i != 0, b1_i, 1.0)
                           * SeE, 0.0)
            f0 = pt_im1 / dEi
            D2 = l2a_i - l1a_i
            A2 = jnp.where(D2 != 0, (l2a_i * (f0 - C2) - ff)
                           / jnp.where(D2 != 0, D2, 1.0), 0.0)
            B2 = jnp.where(D2 != 0, (l1a_i * (f0 - C2) - ff)
                           / jnp.where(D2 != 0, D2, 1.0), 0.0)
            ex1 = jnp.exp(jnp.clip(l1a_i * (Es - E_im1), -700.0, 700.0))
            ex2 = jnp.exp(jnp.clip(l2a_i * (Es - E_im1), -700.0, 700.0))
            pt_sub_a = A2 * ex1 - B2 * ex2 + C2
            exb = jnp.exp(jnp.clip(l1b_i * (Es - E_im1), -700.0, 700.0))
            pt_sub_b = (f0 - SeE / rd0) * exb + SeE / rd0
            pt_sub = jnp.where(cond_i, pt_sub_a, pt_sub_b)
            # integrate Fe1 over the subgrid (sed:2372)
            rd_sub = _interp_rd(E_ip1 - Es, rd_x, rd_y)
            corr = jnp.sum(rd_sub[1:] * pt_sub[1:] * (Es[1:] - Es[:-1]))
            val = first + corr / bb_diag
            pt = pt.at[i].set(val)
            tot = jnp.sum(pt)
            pt = jnp.where(tot > big, pt / tot, pt)
            return pt, None

        iarr = jnp.arange(1, n - 1)
        xs = (iarr, E_arr[2:], E_arr[1:-1], E_arr[:-2], Edot[1:-1],
              cond[1:-1], b1[1:-1], c1[1:-1], l1a[1:-1], l2a[1:-1],
              l1b[1:-1], Re1[1:-1], Re2[1:-1])
        pt0 = jnp.zeros(n).at[0].set(1e-10)
        pt, _ = jax.lax.scan(body, pt0, xs)
        pt = jnp.maximum(pt, 0.0)
        pt = jnp.nan_to_num(pt, nan=0.0)  # sed:2404-2408
        pt = pt / jnp.maximum(jnp.sum(pt), tiny)
        return pt, T_arr

    tmin0 = jnp.maximum(t_eq - 5.0 * sigT, t_eq / 2.0)  # sed:2178-2181
    # hot bound: the reference grows tmax by 30% per outer iteration until
    # P(T) decays at the edge (sed:2389-2400); start instead from the
    # single-photon spike ceiling T(E(t_eq) + max photon energy) so far
    # fewer expansion rounds are needed (physics-equivalent: a grain cannot
    # exceed this enthalpy in the single-photon-heating regime)
    E_eq = interp_extrap(t_eq, eT_x, eT_y)
    t_spike = interp_extrap(E_eq + eph_max, eT_y, eT_x)
    # NOT t_eq + 5 sigT: for sub-table t_eq the Gaussian width estimate is
    # meaningless (extrapolated heat capacity) and would stretch the grid
    # past any physical level, destroying resolution near the spike
    tmax0 = jnp.maximum(1.1 * t_spike, 1.5 * t_eq)

    # range expansion until P(T) decays at both edges (sed:2389-2400);
    # a while_loop keyed on the done flag (vmap lifts the condition to
    # "any grain still expanding") so converged grains stop paying for
    # full level scans, and the final done flag reports grains whose
    # range never stabilized within n_range_iter (not silent truncation)
    def range_cond(state):
        it, _, _, done, _, _ = state
        return (~done) & (it < n_range_iter)

    def range_body(state):
        it, tmin, tmax, done, pt, T_arr = state
        pt_n, T_n = compute_pt(tmin, tmax)
        pt = jnp.where(done, pt, pt_n)
        T_arr = jnp.where(done, T_arr, T_n)
        grow_lo = pt[0] > 1e-20          # sed:2389-2395
        grow_hi = pt[n - 2] > 1e-20
        new_done = done | (~grow_lo & ~grow_hi)
        tmin = jnp.where(done | ~grow_lo, tmin, tmin * 0.7)
        tmax = jnp.where(done | ~grow_hi, tmax, tmax * 1.3)
        return it + 1, tmin, tmax, new_done, pt, T_arr

    state = (jnp.asarray(0), tmin0, tmax0, jnp.asarray(False), jnp.zeros(n),
             make_log_array(tmin0, tmax0, n))
    _, _, _, done, pt, T_arr = jax.lax.while_loop(range_cond, range_body, state)
    return pt, T_arr, done


@partial(jax.jit, static_argnames=("n", "n_sub", "n_range_iter"))
def solve_pt_full_batch(a, eT_x, eT_y, qp_y, rd_y, rd_x, rd0, rd2,
                        t_eq, sigT, eph_max, qp_x, n=N_TEMP_PT,
                        n_sub=N_TEMP_SUB, n_range_iter=10):
    """vmap of _solve_pt_full over a grain batch.  Shapes:
    a/rd0/rd2/t_eq/sigT/eph_max (G,), eT_x/eT_y (G, NT), qp_y (G, 100),
    rd_y (G, L), rd_x (L,) qp_x (100,) shared.

    Must run in float64 (see _f64_context): the dosage moments and the
    exp() exponents of the analytic bin solution are outside the f32
    range.  Callers go through stochastic_emission which forces f64."""
    if a.dtype != jnp.float64:
        raise ValueError("solve_pt_full_batch requires float64 inputs; "
                         "run under sto._f64_context()")
    big = 1e100
    fn = jax.vmap(
        lambda aa, ex, ey, qy, ry, r0, r2, te, sg, em: _solve_pt_full(
            aa, ex, ey, qp_x, qy, rd_x, ry, r0, r2, te, sg, em,
            n, n_sub, n_range_iter, big)
    )
    return fn(a, eT_x, eT_y, qp_y, rd_y, rd0, rd2, t_eq, sigT, eph_max)


# ---------------------------------------------------------------------------
# Gaussian (large-grain) branch — Voit 1991 section 4.4
# ---------------------------------------------------------------------------

def gaussian_pt(Em, sig, eT_x, eT_y, n=N_TEMP_PT):
    """Gaussian enthalpy distribution around equilibrium (calc_gaussian_fE,
    sed:2211-2232).  Em/sig (G,), eT_x/eT_y (G, NT) per-grain enthalpy
    tables (T -> E).  Returns (pt (G, n), T_arr (G, n))."""
    Emin = jnp.maximum(Em - 8.0 * sig, 0.01 * Em)
    Emax = Em + 8.0 * sig
    E = make_log_array(Emin, Emax, n)  # (G, n)
    dE = make_delta_array(E)
    pt = jnp.exp(-0.5 * ((E - Em[:, None]) / sig[:, None]) ** 2) * dE
    pt = pt / jnp.sum(pt, axis=-1, keepdims=True)
    # T(E): invert the per-grain enthalpy table (convert_E_arr_to_T_arr)
    T = jax.vmap(lambda e, ex, ey: interp_extrap(e, ey, ex))(E, eT_x, eT_y)
    return pt, T


# ---------------------------------------------------------------------------
# grain-batch assembly + emission
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StoResult:
    sed: np.ndarray        # (P, Ld) emission SED per problem [W/m/H]
    n_full: int            # grains solved with the full GD89/Voit method
    n_gauss: int           # grains on the Gaussian branch
    n_unconverged: int = 0  # grains whose T range never stabilized


def stochastic_emission(dust, cal, wl, rf_stars, rf_dust=None,
                        n_temp_pt=N_TEMP_PT, n_range_iter=10,
                        grain_chunk=512) -> StoResult:
    """Stochastically heated dust emission for a batch of radiation-field
    problems (the shared core of calc_dens_dustem_sto / _sto_lib,
    sed:548-671 / 673-844).

    rf_stars: (P, Ls) stellar intensity [W/m/m^2] (already converted by
    convert_ufield_ifield); rf_dust: (P, Ld) dust-emission intensity
    [W/m/m^2] or None on the first heating iteration.
    Returns per-problem SEDs in [W/m/H] (multiply by dens_ref/tau_nh_ref
    * parsec^2 for the emissivity grid).
    """
    if dust.qabs_fa is None:
        raise ValueError("'sto' heating requires grain-level dust tables")
    if cal.qabs_planck is None:
        raise ValueError("calorimetry lacks Planck-averaged Qabs: call "
                         "dust.add_planck_avg_qabs first")
    with _f64_context():
        return _stochastic_emission_f64(
            dust, cal, wl, rf_stars, rf_dust,
            n_temp_pt=n_temp_pt, n_range_iter=n_range_iter,
            grain_chunk=grain_chunk)


def _stochastic_emission_f64(dust, cal, wl, rf_stars, rf_dust=None,
                             n_temp_pt=N_TEMP_PT, n_range_iter=10,
                             grain_chunk=512) -> StoResult:
    sl_s, sl_d = wl.stellar_slice, wl.dust_slice
    i0 = sl_d.start
    Ls, Ld, Lt = wl.lnum_stars, wl.lnum_dust, wl.lnum_tot
    lam_si = jnp.asarray(wl.lambda_si)
    lam_d = lam_si[sl_d]
    dl_s = jnp.asarray(wl.delta_lambda_bin_stars)
    dl_d = jnp.asarray(wl.delta_lambda_bin_dust)
    eph = HPLANCK * CSPEED / lam_si  # photon energies (descending)

    P = rf_stars.shape[0]
    C, A, _ = dust.qabs_fa.shape
    qabs = jnp.asarray(dust.qabs_fa)  # (C, A, Lt)
    sizes = jnp.asarray(dust.dust_size_fa)  # (C, A)
    rf_s = jnp.asarray(rf_stars)
    rf_d = jnp.asarray(rf_dust) if rf_dust is not None else None

    # --- per-(p,c,a) absorbed spectra and equilibrium temperature ---------
    # abs spectrum per unit geometric cross section [W/m/m^2]
    abs_s = qabs[None, :, :, sl_s] * rf_s[:, None, None, :]  # (P,C,A,Ls)
    abs_en = jnp.sum(abs_s * dl_s, axis=-1)
    if rf_d is not None:
        abs_d = qabs[None, :, :, sl_d] * rf_d[:, None, None, :]
        abs_en = abs_en + jnp.sum(abs_d * dl_d, axis=-1)
    t_eq = solve_t_equil(qabs[None, :, :, sl_d], lam_d, dl_d, abs_en)

    # --- dosage-function moments Rd0..Rd2 (calc_rd_arr, sed:877-900) ------
    nrate_s = abs_s / eph[sl_s]  # photons /m /m^2 /s
    geo = jnp.pi * sizes**2  # (C, A)
    rd = []
    for m in range(3):
        r = jnp.sum(nrate_s * eph[sl_s] ** m * dl_s, axis=-1)
        if rf_d is not None:
            r = r + jnp.sum(abs_d / eph[sl_d] * eph[sl_d] ** m * dl_d, axis=-1)
        rd.append(r * geo[None])
    rd0, rd1, rd2 = rd  # (P, C, A)

    # --- integrated photon-absorption rate table (sed:2503-2559) ----------
    contrib = jnp.zeros((P, C, A, Lt))
    contrib = contrib.at[..., :Ls].add(nrate_s * dl_s)
    if rf_d is not None:
        contrib = contrib.at[..., i0:].add(abs_d / eph[sl_d] * dl_d)
    rd_int = jnp.cumsum(contrib, axis=-1) * geo[None, :, :, None]
    # reversed: ascending photon energy for interpolation
    rd_x = eph[::-1]
    rd_int_rev = rd_int[..., ::-1]
    # highest photon energy actually absorbed (spike ceiling per grain)
    eph_max = jnp.max(jnp.where(contrib > 0, eph[None, None, None, :], 0.0),
                      axis=-1)

    # --- Gaussian-branch parameters (calc_gaussian_fE, sed:2119-2185) -----
    iq = np.asarray(cal.iq_ct_table[:C])
    calT = jnp.asarray(cal.cal_temp[iq])            # (C, NT)
    calH = jnp.asarray(cal.grain_enthalpy[iq])      # (C, NT) J/m^3
    calC = jnp.asarray(cal.grain_heat_capacity[iq])  # (C, NT) J/m^3/K
    qpT = jnp.asarray(cal.t_arr_planck)             # (100,)
    qpv = jnp.asarray(cal.qabs_planck)              # (C, A, 100)
    vol = 4.0 / 3.0 * jnp.pi * sizes**3             # (C, A)

    # species count is tiny (C <= 4): per-species table lookups on host loop.
    # Clamped (not extrapolated) at the table edges: below the 1 K table
    # start, linear extrapolation of C_T / enthalpy can go negative and
    # poison the Gaussian-width estimate.
    ct = jnp.zeros_like(t_eq)
    Em = jnp.zeros_like(t_eq)
    for c in range(C):
        tc = t_eq[:, c, :]
        ct = ct.at[:, c, :].set(jnp.interp(tc, calT[c], calC[c]))
        Em = Em.at[:, c, :].set(jnp.interp(tc, calT[c], calH[c]))
    Em = Em * vol[None]  # grain enthalpy at T_eq [J]

    tq = t_eq.reshape(P, C * A)
    qpv_f = qpv.reshape(C * A, -1)
    qp_eq = jax.vmap(lambda t, f: interp_extrap(t, qpT, f),
                     in_axes=(1, 0), out_axes=1)(tq, qpv_f).reshape(P, C, A)
    dqp_dt = jax.vmap(lambda t, f: bin_slope(t, qpT, f),
                      in_axes=(1, 0), out_axes=1)(tq, qpv_f).reshape(P, C, A)

    dEdot_dE = 4.0 * SIGMA_SB * t_eq**3 * (4.0 * qp_eq + t_eq * dqp_dt)
    sig = jnp.sqrt(jnp.maximum(
        0.5 * rd2 * sizes[None] * ct * (4.0 / 3.0)
        / jnp.maximum(dEdot_dE, 1e-300), 0.0))
    sigT = sig / jnp.maximum(ct * vol[None], 1e-300)

    active = np.asarray(
        (np.arange(A)[None, :] < dust.n_dust_size[:, None])[None]
        & np.asarray(abs_en > 0)
    )  # (P, C, A)
    valid_g = np.asarray(
        (rd1 / jnp.maximum(rd0, 1e-300) / jnp.maximum(Em, 1e-300) < 0.01)
        & (2.0 * sigT / jnp.maximum(t_eq, 1e-300) < 0.1)
    )
    # latch: Gaussian only while every *larger* active grain of the same
    # species was Gaussian-valid (large_grain_energy, sed:604-630)
    ok = np.where(active, valid_g, True)
    use_gauss = np.flip(np.cumprod(np.flip(ok, axis=-1), axis=-1), axis=-1)
    use_gauss = use_gauss.astype(bool) & valid_g & active
    full_mask = active & ~use_gauss

    # --- solve pt for all active grains ------------------------------------
    pt_all = np.zeros((P, C, A, n_temp_pt))
    T_all = np.ones((P, C, A, n_temp_pt))

    gi = np.argwhere(use_gauss)
    if len(gi):
        p_, c_, a_ = gi.T
        eT_x = calT[c_]
        eT_y = calH[c_] * vol[c_, a_][:, None]
        pt_g, T_g = gaussian_pt(
            jnp.asarray(np.asarray(Em)[p_, c_, a_]),
            jnp.asarray(np.asarray(sig)[p_, c_, a_]),
            eT_x, eT_y, n=n_temp_pt)
        pt_all[p_, c_, a_] = np.asarray(pt_g)
        T_all[p_, c_, a_] = np.asarray(T_g)

    def _solve_batch(idx, niter):
        """Solve a (P,C,A)-index batch padded to grain_chunk; returns
        (pt, T, done) for the un-padded rows."""
        p_, c_, a_ = idx.T
        nb = len(p_)
        pad = grain_chunk - nb  # pad to a single static shape (one compile)
        if pad:
            p_ = np.concatenate([p_, np.repeat(p_[-1], pad)])
            c_ = np.concatenate([c_, np.repeat(c_[-1], pad)])
            a_ = np.concatenate([a_, np.repeat(a_[-1], pad)])
        pt_f, T_f, done_f = solve_pt_full_batch(
            sizes[c_, a_],
            calT[c_], calH[c_] * vol[c_, a_][:, None],
            qpv[c_, a_],
            rd_int_rev[p_, c_, a_], rd_x,
            jnp.asarray(np.asarray(rd0)[p_, c_, a_]),
            jnp.asarray(np.asarray(rd2)[p_, c_, a_]),
            jnp.asarray(np.asarray(t_eq)[p_, c_, a_]),
            jnp.asarray(np.asarray(sigT)[p_, c_, a_]),
            jnp.asarray(np.asarray(eph_max)[p_, c_, a_]),
            qpT, n=n_temp_pt, n_range_iter=niter)
        return (np.asarray(pt_f)[:nb], np.asarray(T_f)[:nb],
                np.asarray(done_f)[:nb])

    fi = np.argwhere(full_mask)
    capped = []
    for b0 in range(0, len(fi), grain_chunk):
        idx = fi[b0:b0 + grain_chunk]
        pt_f, T_f, done_f = _solve_batch(idx, n_range_iter)
        p_, c_, a_ = idx.T
        pt_all[p_, c_, a_] = pt_f
        T_all[p_, c_, a_] = T_f
        capped.append(idx[~done_f])
    capped = np.concatenate(capped) if capped else np.zeros((0, 3), int)

    # escalation (cf. the reference's unconditional loop
    # sed_routines.f90:2389-2400): grains whose T range never stabilized
    # within n_range_iter get ONE retry with a generous expansion budget
    # so the truncated-P(T) energy defect is not silently carried
    n_unconverged = 0
    niter_esc = max(4 * n_range_iter, 40)
    if len(capped):
        for b0 in range(0, len(capped), grain_chunk):
            idx = capped[b0:b0 + grain_chunk]
            pt_f, T_f, done_f = _solve_batch(idx, niter_esc)
            p_, c_, a_ = idx.T
            pt_all[p_, c_, a_] = pt_f
            T_all[p_, c_, a_] = T_f
            n_unconverged += int((~done_f).sum())
    if n_unconverged:
        import warnings

        warnings.warn(
            f"sto: {n_unconverged} grain(s) still hit the T-range expansion "
            f"cap after escalation to n_range_iter={niter_esc}; "
            "their P(T) may be truncated",
            RuntimeWarning, stacklevel=2)

    # --- emission: sum over P(T) levels and integrate over sizes ----------
    # dust_em_arr_fa (sed:632-640): pi a^2 Qabs(l) sum_t pt B(T_t, l) f(a);
    # tot_dust_em (sed:652-656): 4 pi sum_a ... da   [W/m/H]
    wsize = np.asarray(dust.dust_fa * dust.delta_dust_size)  # (C, A)
    wsize = np.where(np.arange(A)[None, :] < dust.n_dust_size[:, None],
                     wsize, 0.0)
    sed = np.zeros((P, Ld))
    flat_pt = pt_all.reshape(-1, n_temp_pt)
    flat_T = T_all.reshape(-1, n_temp_pt)
    flat_w = np.broadcast_to(
        (np.asarray(geo) * wsize)[None], (P, C, A)).reshape(-1)
    flat_q = np.broadcast_to(
        np.asarray(qabs[:, :, sl_d])[None], (P, C, A, Ld)).reshape(-1, Ld)
    flat_p = np.broadcast_to(
        np.arange(P)[:, None, None], (P, C, A)).reshape(-1)
    act = np.broadcast_to(active, (P, C, A)).reshape(-1)
    sel = np.flatnonzero(act)

    @jax.jit
    def emit(pt, T, q, w):
        B = bplanck(T[:, :, None], lam_d[None, None, :])  # (g, n, Ld)
        return 4.0 * jnp.pi * w[:, None] * q * jnp.einsum("gn,gnl->gl", pt, B)

    chunk = 4096
    for b0 in range(0, len(sel), chunk):
        ii = sel[b0:b0 + chunk]
        contrib_sed = np.asarray(emit(
            jnp.asarray(flat_pt[ii]), jnp.asarray(flat_T[ii]),
            jnp.asarray(flat_q[ii]), jnp.asarray(flat_w[ii])))
        np.add.at(sed, flat_p[ii], contrib_sed)

    return StoResult(sed=sed, n_full=len(fi), n_gauss=len(gi),
                     n_unconverged=n_unconverged)


# ---------------------------------------------------------------------------
# per-cell driver ('sto') and adaptive-library driver ('sto_lib')
# ---------------------------------------------------------------------------

def dens_dustem_sto(dust, cal, wl, dens_ref, u_stellar, u_dust=None,
                    units_ufield="erg/Hz/pc^3", cell_chunk=256,
                    n_temp_pt=N_TEMP_PT, n_range_iter=10):
    """Per-cell stochastically heated emission (calc_dens_dustem_sto,
    sed:548-671).  Returns (ncell, Ld) emissivity [W/m/pc^3]."""
    dref = np.asarray(dens_ref)
    sel = np.flatnonzero(dref > 0)
    ncell = len(dref)
    out = np.zeros((ncell, wl.lnum_dust))
    rf_stars = np.asarray(convert_ufield_ifield(
        np.asarray(u_stellar), wl.lambda_si[wl.stellar_slice], units_ufield))
    rf_dust = (np.asarray(u_dust) / PARSEC**3 * CSPEED
               if u_dust is not None else None)
    for b0 in range(0, len(sel), cell_chunk):
        idx = sel[b0:b0 + cell_chunk]
        res = stochastic_emission(
            dust, cal, wl, rf_stars[idx],
            rf_dust[idx] if rf_dust is not None else None,
            n_temp_pt=n_temp_pt, n_range_iter=n_range_iter)
        out[idx] = res.sed / dust.tau_nh_ref * dref[idx][:, None] * PARSEC**2
    return out


LAMBDA_SEP_UV_OPT = 0.443  # um, UV/optical boundary (bin_rad_field sed:2926)


def bin_rad_field(wl, dens_ref, u_stellar, u_dust, n_int_rf_bins):
    """Bin dusty cells by their integrated UV and optical radiation fields
    on an (n x n) log grid and average the spectra per bin (bin_rad_field,
    sed:2925-3010).  Returns (ibin (ncell,), u_av_stars (n,n,Ls),
    u_av_dust (n,n,Ld), count (n,n))."""
    lam = np.asarray(wl.lambda_um[wl.stellar_slice])
    nuv = max(int(np.searchsorted(lam, LAMBDA_SEP_UV_OPT)), 2)
    dref = np.asarray(dens_ref)
    us = np.asarray(u_stellar)
    dusty = dref > 0
    lam_uv = lam[:nuv] * 1e-6
    lam_opt = lam[nuv - 1:] * 1e-6
    int_uv = np.trapezoid(us[:, :nuv], lam_uv, axis=1)
    int_opt = np.trapezoid(us[:, nuv - 1:], lam_opt, axis=1)

    def edges(v):
        vpos = v[dusty & (v > 0)]
        if len(vpos) == 0:
            return np.array([1.0, 2.0])
        lo, hi = vpos.min(), vpos.max()
        if lo == hi:
            hi = lo * (1 + 1e-9)
        return np.logspace(np.log10(lo), np.log10(hi), n_int_rf_bins + 1)

    e_uv, e_opt = edges(int_uv), edges(int_opt)
    iuv = np.clip(np.searchsorted(e_uv, int_uv) - 1, 0, n_int_rf_bins - 1)
    iopt = np.clip(np.searchsorted(e_opt, int_opt) - 1, 0, n_int_rf_bins - 1)
    ibin = np.where(dusty, iuv * n_int_rf_bins + iopt, -1)

    nb = n_int_rf_bins * n_int_rf_bins
    Ls = us.shape[1]
    u_av_s = np.zeros((nb, Ls))
    count = np.zeros(nb)
    np.add.at(count, ibin[dusty], 1.0)
    np.add.at(u_av_s, ibin[dusty], us[dusty])
    u_av_d = None
    if u_dust is not None:
        ud = np.asarray(u_dust)
        u_av_d = np.zeros((nb, ud.shape[1]))
        np.add.at(u_av_d, ibin[dusty], ud[dusty])
        u_av_d = u_av_d / np.maximum(count[:, None], 1.0)
    u_av_s = u_av_s / np.maximum(count[:, None], 1.0)
    return ibin, u_av_s, u_av_d, count


def dens_dustem_sto_lib(dust, cal, wl, dens_ref, u_stellar, u_dust=None,
                        n_int_rf_bins=20, units_ufield="erg/Hz/pc^3",
                        n_temp_pt=N_TEMP_PT, n_range_iter=10):
    """Adaptive SED-library stochastic emission, Natale et al. 2015
    (calc_dens_dustem_sto_lib, sed:673-844): solve the full stochastic
    problem once per occupied (UV, optical) radiation-field bin and assign
    the bin SED to every member cell.  Returns (ncell, Ld) [W/m/pc^3]."""
    dref = np.asarray(dens_ref)
    ibin, u_av_s, u_av_d, count = bin_rad_field(
        wl, dref, u_stellar, u_dust, n_int_rf_bins)
    occ = np.flatnonzero(count > 0)
    rf_stars = np.asarray(convert_ufield_ifield(
        u_av_s[occ], wl.lambda_si[wl.stellar_slice], units_ufield))
    rf_dust = (u_av_d[occ] / PARSEC**3 * CSPEED
               if u_av_d is not None else None)
    res = stochastic_emission(dust, cal, wl, rf_stars, rf_dust,
                              n_temp_pt=n_temp_pt, n_range_iter=n_range_iter)
    sed_by_bin = np.zeros((n_int_rf_bins * n_int_rf_bins, wl.lnum_dust))
    sed_by_bin[occ] = res.sed
    out = np.zeros((len(dref), wl.lnum_dust))
    dusty = dref > 0
    out[dusty] = (sed_by_bin[ibin[dusty]] / dust.tau_nh_ref
                  * dref[dusty][:, None] * PARSEC**2)
    return out
