"""Stochastic dust heating ('sto'/'sto_lib') tests: calorimetry loading,
Planck-averaged Qabs, Gaussian-vs-equilibrium consistency, full
Guhathakurta-Draine/Voit solve energy conservation, and sto_lib == sto on
a uniform radiation field."""
import os

import numpy as np
import pytest
import jax.numpy as jnp

from dartray_tpu import dust as D, sto
from dartray_tpu import dust_emission as DE
from dartray_tpu.constants import SIGMA_SB
from dartray_tpu.wavelength import make_wavelength_grid

DATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data"
)


def _wl():
    lam = np.concatenate([np.logspace(-1.5, 0.4, 14), np.logspace(0.5, 3, 18)])
    return make_wavelength_grid(lam, max_lambda_stars=2.6, min_lambda_dust=1.0)


def _gray_model(wl, sizes, fa=1e5, dsize=1e-8):
    """Single-species gray (Qabs=1) grain model — closed-form checks."""
    L = wl.lnum_tot
    sizes = np.atleast_2d(sizes)
    A = sizes.shape[1]
    return D.DustModel(
        lambda_um=wl.lambda_um, kabs=np.ones(L) * 1e-13,
        ksca=np.full(L, 1e-14), kext=np.ones(L) * 1.1e-13,
        gsca=np.zeros(L), kext_ref=1e-13, tau_nh_ref=1e-25,
        dust_size_fa=sizes, dust_fa=np.full((1, A), fa),
        delta_dust_size=np.full((1, A), dsize),
        qabs_fa=np.ones((1, A, L)), n_dust_size=np.array([A]),
    )


def _cal(dm, wl):
    cal = D.load_calorimetry(os.path.join(DATA, "DUST_OPACITY"),
                             n_comp=dm.qabs_fa.shape[0])
    return D.add_planck_avg_qabs(cal, dm, wl.lambda_si, wl.delta_lambda_bin)


def _absorbed(dm, wl, rf):
    """Total absorbed power per H [W/H] for a gray model."""
    geo = np.pi * dm.dust_size_fa[0] ** 2
    w = dm.dust_fa[0] * dm.delta_dust_size[0]
    abs_pg = (rf * wl.delta_lambda_bin_stars).sum()
    return (abs_pg * geo * w).sum()


def test_calorimetry_tables():
    cal = D.load_calorimetry(os.path.join(DATA, "DUST_OPACITY"), n_comp=3)
    assert cal.cal_temp.shape == (2, 1000)
    # graphite: first row of the file is (1 K, 7.87902 erg/g, 29.6603 erg/g/K)
    # with density 2.24 g/cm^3, converted to J/m^3 (load_cT_hT_tables,
    # sed_routines.f90:1643-1655)
    np.testing.assert_allclose(cal.cal_temp[0, 0], 1.0)
    np.testing.assert_allclose(cal.grain_enthalpy[0, 0],
                               7.87902 * 2.24 * 0.1, rtol=1e-6)
    np.testing.assert_allclose(cal.grain_heat_capacity[0, 0],
                               29.6603 * 2.24 * 0.1, rtol=1e-6)
    # monotone in T
    assert np.all(np.diff(cal.cal_temp, axis=1) > 0)
    assert np.all(np.diff(cal.grain_enthalpy, axis=1) > 0)
    # species mapping: Gra/PAH graphitic, Sil silicate
    np.testing.assert_array_equal(cal.iq_ct_table, [0, 1, 0])


def test_planck_avg_qabs_gray():
    """Constant Qabs=1 must Planck-average to exactly 1 at every T."""
    wl = _wl()
    dm = _gray_model(wl, [[1e-8]])
    cal = _cal(dm, wl)
    assert cal.qabs_planck.shape == (1, 1, 100)
    np.testing.assert_allclose(cal.qabs_planck, 1.0, rtol=1e-12)
    assert cal.t_arr_planck[0] == 1.0 and abs(cal.t_arr_planck[-1] - 2500) < 1


def test_gaussian_branch_matches_equilibrium():
    """A large grain in a strong field stays on the Gaussian branch and its
    SED must match the delta-function equilibrium SED."""
    wl = _wl()
    a = 2e-7
    dm = _gray_model(wl, [[a]])
    cal = _cal(dm, wl)
    rf = np.full((1, wl.lnum_stars), 1e8)
    res = sto.stochastic_emission(dm, cal, wl, rf, n_temp_pt=150,
                                  grain_chunk=8)
    assert res.n_gauss == 1 and res.n_full == 0
    emitted = (res.sed[0] * wl.delta_lambda_bin_dust).sum()
    np.testing.assert_allclose(emitted, _absorbed(dm, wl, rf[0]), rtol=1e-3)
    # equilibrium SED comparison
    lam_d = wl.lambda_si[wl.dust_slice]
    dl_d = wl.delta_lambda_bin_dust
    abs_pg = (rf[0] * wl.delta_lambda_bin_stars).sum()
    T_eq = float(DE.solve_t_equil(jnp.ones(wl.lnum_dust), jnp.asarray(lam_d),
                                  jnp.asarray(dl_d), jnp.asarray(abs_pg)))
    geo = np.pi * a**2
    w = dm.dust_fa[0, 0] * dm.delta_dust_size[0, 0]
    sed_eq = 4 * np.pi * geo * w * np.asarray(DE.bplanck(T_eq, lam_d))
    keep = sed_eq > sed_eq.max() * 1e-3
    np.testing.assert_allclose(res.sed[0][keep], sed_eq[keep], rtol=0.05)


def test_full_solve_energy_conservation():
    """Small grains in a moderate field take the full stochastic solve;
    the P(T) distribution must conserve energy (bolometric, gray grain:
    emitted = sum pt * 4 pi a^2 sigma T^4 = absorbed) and the SED integral
    must match where the wavelength grid covers the Planck peak."""
    wl = _wl()
    dm = _gray_model(wl, [[3e-9, 1e-8, 3e-8]])
    cal = _cal(dm, wl)
    rf = np.full((1, wl.lnum_stars), 1e2)  # T_eq ~ 80 K: peak well on-grid
    res = sto.stochastic_emission(dm, cal, wl, rf, n_temp_pt=200,
                                  grain_chunk=4)
    assert res.n_full >= 2  # small grains are stochastic
    emitted = (res.sed[0] * wl.delta_lambda_bin_dust).sum()
    np.testing.assert_allclose(emitted, _absorbed(dm, wl, rf[0]), rtol=0.15)


def test_sto_spectrum_broader_than_equilibrium():
    """Stochastic heating boosts short-wavelength dust emission: for tiny
    grains the SED at the Wien side must exceed the single-temperature
    equilibrium SED by orders of magnitude."""
    wl = _wl()
    a = 3e-9
    dm = _gray_model(wl, [[a]])
    cal = _cal(dm, wl)
    rf = np.full((1, wl.lnum_stars), 1e2)
    res = sto.stochastic_emission(dm, cal, wl, rf, n_temp_pt=200,
                                  grain_chunk=4)
    lam_d = wl.lambda_si[wl.dust_slice]
    abs_pg = (rf[0] * wl.delta_lambda_bin_stars).sum()
    T_eq = float(DE.solve_t_equil(jnp.ones(wl.lnum_dust), jnp.asarray(lam_d),
                                  jnp.asarray(wl.delta_lambda_bin_dust),
                                  jnp.asarray(abs_pg)))
    geo = np.pi * a**2
    w = dm.dust_fa[0, 0] * dm.delta_dust_size[0, 0]
    sed_eq = 4 * np.pi * geo * w * np.asarray(DE.bplanck(T_eq, lam_d))
    # shortest dust wavelength: stochastic spikes dominate
    assert res.sed[0, 0] > 10 * sed_eq[0]


def test_sto_lib_equals_sto_on_uniform_field():
    """With an identical field in every cell, the library binning puts all
    cells in one bin and sto_lib must equal per-cell sto exactly."""
    wl = _wl()
    dm = _gray_model(wl, [[1e-8, 1e-7]])
    cal = _cal(dm, wl)
    ncell = 6
    dens_ref = np.array([0.5, 0.0, 1.0, 2.0, 0.25, 0.0])
    u = np.full((ncell, wl.lnum_stars), 3e20)  # erg/Hz/pc^3
    out_sto = sto.dens_dustem_sto(dm, cal, wl, dens_ref, u, n_temp_pt=120)
    out_lib = sto.dens_dustem_sto_lib(dm, cal, wl, dens_ref, u,
                                      n_int_rf_bins=12, n_temp_pt=120)
    assert out_sto.shape == (ncell, wl.lnum_dust)
    np.testing.assert_allclose(out_lib, out_sto, rtol=1e-10)
    assert np.all(out_sto[dens_ref == 0] == 0)
    # emissivity scales linearly with dens_ref
    np.testing.assert_allclose(out_sto[3], 8 * out_sto[4], rtol=1e-10)


def test_sto_lib_bins_distinct_fields():
    """Cells with very different fields land in different bins and get
    different SED shapes (hotter field -> bluer dust SED)."""
    wl = _wl()
    dm = _gray_model(wl, [[1e-8]])
    cal = _cal(dm, wl)
    dens_ref = np.ones(4)
    u = np.stack([np.full(wl.lnum_stars, 1e18),
                  np.full(wl.lnum_stars, 1e18),
                  np.full(wl.lnum_stars, 1e24),
                  np.full(wl.lnum_stars, 1e24)])
    out = sto.dens_dustem_sto_lib(dm, cal, wl, dens_ref, u,
                                  n_int_rf_bins=12, n_temp_pt=120)
    np.testing.assert_allclose(out[0], out[1], rtol=1e-12)
    np.testing.assert_allclose(out[2], out[3], rtol=1e-12)
    # hotter cells emit more, with a bluer peak
    assert out[2].sum() > 1e3 * out[0].sum()
    assert np.argmax(out[2]) <= np.argmax(out[0])


def test_run_dust_rt_sto_lib_smoke():
    """End-to-end dust self-heating loop with sto_lib heating on a tiny
    slab: converges and produces IR emission."""
    from dartray_tpu import pipeline as P
    from dartray_tpu.models import trustI
    from dartray_tpu.config import RTConfig

    grid = trustI.build_trustI_grid(
        tau_z=1.0, base=(6, 2), max_lvl=1, min_lvl=1, max_ncell=20_000
    )
    # grid limited to the tabulated blackbody range (>= 0.1 um)
    lam = np.concatenate([np.logspace(-1, 0.4, 11), np.logspace(0.5, 3, 14)])
    wl = make_wavelength_grid(lam, max_lambda_stars=2.6, min_lambda_dust=1.0)
    dm = _gray_model(wl, [[1e-8, 1e-7]])
    cal = _cal(dm, wl)
    cfg = RTConfig(
        accuracy=0.4, bm_par=2, bm_par_sca=2, bm_par_max=40, rad_lim=0.3,
        kp_sca_max=0, conv_en_lim=0.1, dist_obs=1e4,
        use_p_src=True, dust_heating_type="sto_lib", only_direct_rt=True,
        n_int_rf_bins=11,
    ).validate()
    tl, tf = trustI.read_planck_table(
        os.path.join(DATA, "TRUSTI_GRIDS/BB_T10000_L100000.dat"))
    lum = trustI.source_luminosity(wl.lambda_um, tl, tf)[None, :]
    stellar = P.run_main(
        grid, cfg, wl, dm,
        p_src_pos=trustI.STAR_POS[None, :], p_src_lum=lum[:, wl.stellar_slice],
        lambda_range="stars", chunk=16,
    )
    dres = P.run_dust_rt(grid, cfg, wl, dm, stellar.u_final, chunk=16,
                         max_dust_iterations=3, cal=cal)
    assert dres.u_dust.shape == (grid.n_cells, wl.lnum_dust)
    assert np.all(np.isfinite(dres.u_dust))
    assert dres.u_dust.max() > 0


def test_sto_f32_session_routes_to_f64():
    """In a float32 session (the production default on the GPU) the
    stochastic solve must still run in float64 via sto._f64_context, on
    the default device, and agree with the x64-session result (float32
    underflows the Rd2 moments)."""
    import jax

    wl = _wl()
    dm = _gray_model(wl, [[3e-9, 1e-8]])
    cal = _cal(dm, wl)
    rf = np.full((1, wl.lnum_stars), 1e2)
    ref = sto.stochastic_emission(dm, cal, wl, rf, n_temp_pt=120,
                                  grain_chunk=4)
    with jax.enable_x64(False):
        assert not jax.config.jax_enable_x64
        res = sto.stochastic_emission(dm, cal, wl, rf, n_temp_pt=120,
                                      grain_chunk=4)
    assert res.n_full == ref.n_full
    np.testing.assert_allclose(res.sed, ref.sed, rtol=1e-10)


def test_capped_grain_escalation_conserves_energy():
    """T-range expansion cap escalation (cf. the
    reference's unconditional expansion loop sed_routines.f90:2389-2400):
    with a deliberately tiny n_range_iter the first solve hits the cap;
    the automatic 4x retry must recover a converged, energy-conserving
    P(T), matching the default-budget run."""
    import warnings

    wl = _wl()
    dm = _gray_model(wl, [[3e-9, 1e-8]])
    cal = _cal(dm, wl)
    rf = np.full((1, wl.lnum_stars), 1e2)

    res_ref = sto.stochastic_emission(dm, cal, wl, rf, n_temp_pt=200,
                                      grain_chunk=4)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # escalation must silence the warning
        res_cap = sto.stochastic_emission(dm, cal, wl, rf, n_temp_pt=200,
                                          grain_chunk=4, n_range_iter=3)
    assert res_cap.n_unconverged == 0
    emitted = (res_cap.sed[0] * wl.delta_lambda_bin_dust).sum()
    np.testing.assert_allclose(emitted, _absorbed(dm, wl, rf[0]), rtol=0.15)
    np.testing.assert_allclose(res_cap.sed, res_ref.sed, rtol=1e-6)
