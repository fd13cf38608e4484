"""Single-scattering analytic oracle for the TRUST I slab.

Pins the scaspe/HG/albedo chain against physics (not just energy budgets):
the first-order scattered flux toward an external observer has the closed
form

    F_1(n) * d^2 = int dV  rho*k_sca * [L e^{-tau_in} / (4 pi r^2)]
                          * Phi(s, n) / (4 pi) * e^{-tau_out}

where s is the direction source->x, tau_in/tau_out are the slab optical
depths along the in/out paths (closed form for a z-slab and vertical
observers), and Phi is the Henyey-Greenstein phase factor in the
framework's *discrete* normalization (calc_ffn_arr,
rt_routines.f90:2186-2281): Phi = w(cos a) * npix_hp / sum_p w(cos a_p)
over the npix_hp HEALPix pixel directions.  Using the discrete
normalization removes the dominant angular-discretization term, so the
comparison tolerance is set by ray/cell discretization only.

The framework side is exactly first order: direct pass -> scaspe, then the
observer-intensity stage sourced by the *direct* scaspe (the appended
observer columns, rt_loop_iobs rt_routines.f90:1519-1548).  Workload:
the TRUST I benchmark geometry (user_routines_trustI.f90:15-19) at
tau_z = 0.1.
"""
import os

import numpy as np
import pytest

from dartray_tpu.config import RTConfig
from dartray_tpu.constants import PARSEC
from dartray_tpu.wavelength import make_wavelength_grid
from dartray_tpu import dust as D
from dartray_tpu.models import trustI
from dartray_tpu import pipeline as P
from dartray_tpu.rt import engine as E
from dartray_tpu.rt import scattering as SC

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
AV_OPAC = os.path.join(DATA, "DUST_OPACITY", "TRUST", "ZDA_BARE_GR_S_Effective.dat")
BB_TABLE = os.path.join(DATA, "TRUSTI_GRIDS", "BB_T10000_L100000.dat")

TAU_Z = 0.1
LAM = [0.4, 1.0]  # g ~ 0.6 and ~0.45: two distinct HG shapes


@pytest.fixture(scope="module")
def run():
    grid = trustI.build_trustI_grid(
        tau_z=TAU_Z, base=(10, 2), max_lvl=2, min_lvl=1, max_ncell=200_000
    )
    wl = make_wavelength_grid(np.asarray(LAM), max_lambda_stars=80.0)
    dustm = D.load_effective_dust_model(AV_OPAC, wl.lambda_um, lambda_ref=1.0)
    tl, tf = trustI.read_planck_table(BB_TABLE)
    lum = trustI.source_luminosity(wl.lambda_um, tl, tf)[None, :]
    cfg = RTConfig(
        accuracy=0.05, bm_par=15, bm_par_sca=10, bm_par_max=300, rad_lim=0.1,
        dist_obs=1e4, use_p_src=True, use_dir_out=True, print_sed=True,
        kp_sca_max=2,
    ).validate()
    dir_out = np.array([[0.0, 0.0], [np.pi, 0.0]])  # up (+z), down (-z)
    scfg = SC.ScaspeConfig.make(cfg.kp_sca_max, np.asarray(dustm.gsca), dir_out)
    direct = P.run_direct_light(
        grid, cfg, wl, dustm,
        p_src_pos=trustI.STAR_POS[None, :], p_src_lum=lum,
        dir_out=dir_out, collect_scaspe=True, scaspe_cfg=scfg,
    )
    # first-order scattered observer intensities: iobs stage sourced by the
    # DIRECT scaspe only (no scattering iterations => exactly single
    # scattering)
    sl = wl.stellar_slice
    phys = P.make_physics(grid, dustm, sl)
    scaspe_np = SC.ScaspeConfig.asarray(direct.scaspe)
    lumcell = scfg.lumcell(scaspe_np)
    leaf = np.asarray(grid.leaf_mask())
    sel = np.flatnonzero(leaf & (lumcell.sum(axis=1) > 0))
    sources = E.SourceSet(
        pos=np.asarray(grid.ccoord)[sel], cell=sel, sid=sel,
        lum=lumcell[sel], point=False,
    )
    i_obs_sca, _ = E.run_iobs_stage(
        grid, phys, sources, dir_out=dir_out,
        n_sid=grid.n_cells + 1,
        src_lum_dir_fn=lambda j, cells: scfg.obs_lum(scaspe_np, cells, j),
    )
    # flux per direction: sum_cells i_obs * (csize/d)^2 in Jy (calc_sed)
    csize = np.asarray(grid.csize)
    d_cm = cfg.dist_obs * PARSEC * 100
    f_jy = np.zeros((2, len(LAM)))
    for j in range(2):
        f_jy[j] = (
            (i_obs_sca[: grid.n_cells, j] * (csize**2)[:, None]).sum(axis=0)
            * 4 * np.pi / (4 * np.pi * d_cm**2) * 1e23
        )
    return grid, dustm, lum[0], scfg, f_jy


@pytest.mark.parametrize("j", [0, 1], ids=["up", "down"])
def test_single_scattering_matches_analytic(run, j):
    grid, dustm, lum_l, scfg, f_jy = run
    expect = trustI.single_scattering_flux_jy(
        dustm.kext / dustm.kext_ref, dustm.albedo, dustm.gsca, lum_l, scfg,
        TAU_Z, up=(j == 0), dist_pc=1e4)
    ratio = f_jy[j] / expect
    # tolerance: ray/beam + cell discretization (the HG discretization is
    # matched exactly by the discrete normalization above)
    assert np.all(np.abs(ratio - 1) < 0.08), (ratio, f_jy[j], expect)
