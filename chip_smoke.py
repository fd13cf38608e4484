"""Smoke run of the main path on NVIDIA GPUs, at the full width of the
reference's TRUST I benchmark (data/TRUSTI_GRIDS/input_trustI_tau0.01_LD.in:
180,201 cells, 32 stellar wavelengths, 753 scaspe floats per cell).

    python chip_smoke.py          # one card, phases 1-6
    python chip_smoke.py --four   # four cards: phases 2 and 4 as four
                                  # processes (one card each) and on 4-card
                                  # meshes, each compared with one card

Phases (one card):
  1 setup        the TRUST I LD grid, built in memory
  2 direct       precalc + direct light with scaspe + i_obs
                 (pipeline.run_direct_light) against the analytic fluxes;
                 lum_lost < 1%; energy closure
  3 single       the observer stage sourced by the direct scaspe against
                 the closed-form first-order scattering integral, at
                 tau_z = 0.1 where that check's tolerance was set
  4 scattering   one scattering.run_scattering iteration from every
                 EVERY-th source cell; energy closure
  5 gradient     jax.grad of replay.replay_iobs on the card against the
                 same replay on the CPU backend in float64
  6 stochastic   sto.stochastic_emission in a float32 session (float64 on
                 the card) against the CPU backend

Each phase runs twice and prints its wall time, its compile time (first
call minus warm call), its checks with their tolerances and the device's
peak memory.  A failed check raises.  Without a GPU the run stops before
the first phase with a non-zero exit.  The last line of the output is
one JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
from dartray_tpu import runtime  # noqa: E402  (stays off JAX)

DATA = os.path.join(ROOT, "data")
NAMELIST = os.path.join(DATA, "TRUSTI_GRIDS", "input_trustI_tau0.01_LD.in")
AV_OPAC = os.path.join(DATA, "DUST_OPACITY", "TRUST",
                       "ZDA_BARE_GR_S_Effective.dat")

EVERY = 24  # phase 4 source stride on one card: about a minute per run
EVERY_FOUR = 64  # the same phase in each --four configuration
GRAD_SOURCES = 4096  # phase 5: slab cells traced toward one observer
# the single-scattering check's tolerance was set at this depth
# (tests/test_single_scattering.py)
TAU_SINGLE = 0.1


def check(ok, msg):
    print(f"  [{'ok' if ok else 'FAIL'}] {msg}", flush=True)
    if not ok:
        raise AssertionError(msg)


def _peak_memory():
    import jax

    ms = jax.devices()[0].memory_stats()
    if not ms:
        return "not reported by this backend"
    return f"{ms['peak_bytes_in_use'] / 2**30:.2f} GiB"


def _runs(fn, runs):
    """fn() `runs` times; returns (last result, wall seconds of each)."""
    walls = []
    out = None
    for _ in range(runs):
        t = time.perf_counter()
        out = fn()
        walls.append(time.perf_counter() - t)
    return out, walls


def _report(name, walls):
    if len(walls) > 1:
        print(f"  {name}: first call {walls[0]:.3f} s, warm call "
              f"{walls[-1]:.3f} s, compile {walls[0] - walls[-1]:.3f} s",
              flush=True)
    else:
        print(f"  {name}: {walls[0]:.3f} s (one call, compile included)",
              flush=True)


def _stage_line(label, st, prefix):
    rays = st.get(prefix + "rays", 0)
    steps = st.get(prefix + "steps", 0)
    iters = st.get(prefix + "iters", 0)
    wall = st.get(prefix + "wall_s", 0.0)
    print(f"  {label:12s} {wall:8.3f} s  rays={rays} intersections={steps} "
          f"loop_iters={iters} intersections/iter="
          f"{steps / max(iters, 1):.0f}", flush=True)


# ---------------------------------------------------------------------------
# phase 1: the problem
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Problem:
    grid: object
    cfg: object
    wl: object
    dust: object
    src_pos: np.ndarray  # (1, 3)
    src_lum: np.ndarray  # (1, L) [erg/s/Hz]
    dir_out: np.ndarray  # (ndir, 2) observers (theta, phi)
    tau_z: float


def setup(tau_z=0.01, max_lvl=4, lam=None) -> Problem:
    """The TRUST I slab at vertical depth tau_z, with the namelist's run
    configuration, observers and point source.  ``lam`` replaces the
    namelist's wavelength list (for small test runs)."""
    from dartray_tpu import dust as D
    from dartray_tpu.config import load_config
    from dartray_tpu.models import trustI
    from dartray_tpu.wavelength import make_wavelength_grid, read_lambda_list

    tgrids = os.path.join(DATA, "TRUSTI_GRIDS")
    cfg = load_config(NAMELIST)
    # walls off: the namelist's z walls bound the slab ([-5, -2] pc), so the
    # star at z = 4 pc lies outside them, and the direct stage would stop
    # every ray before the slab (u = 0 there, nothing booked as lost)
    cfg = dataclasses.replace(cfg, z_wall_on=False)
    grid = trustI.build_trustI_grid(
        tau_z=tau_z, base=(10, 2), max_lvl=max_lvl, min_lvl=1,
        max_ncell=4_000_000,
    )
    if lam is None:
        lam = read_lambda_list(os.path.join(tgrids, cfg.file_lambda_list))
    wl = make_wavelength_grid(np.asarray(lam), cfg.max_lambda_stars,
                              cfg.min_lambda_dust)
    dust = D.load_effective_dust_model(AV_OPAC, wl.lambda_um,
                                       lambda_ref=cfg.lambda_ref)
    tl, tf = trustI.read_planck_table(
        os.path.join(tgrids, "BB_T10000_L100000.dat"))
    src_pos = np.atleast_2d(
        np.loadtxt(os.path.join(tgrids, cfg.file_p_src), skiprows=1))
    src_lum = trustI.source_luminosity(
        wl.lambda_um[wl.stellar_slice], tl, tf)[None, :]
    dir_out = np.atleast_2d(
        np.loadtxt(os.path.join(tgrids, cfg.file_dir_out), skiprows=1))
    return Problem(grid, cfg, wl, dust, src_pos, src_lum, dir_out, tau_z)


def _stellar(prob, a):
    return np.asarray(a)[prob.wl.stellar_slice]


def _tau_cell_max(prob):
    """Largest optical depth of one intersection (a leaf cell's
    diagonal), per wavelength."""
    leaf = np.asarray(prob.grid.leaf_mask())
    tau = (np.asarray(prob.grid.dens_ref) * np.asarray(prob.grid.csize))[leaf]
    kn = _stellar(prob, prob.dust.kext) / prob.dust.kext_ref
    return np.sqrt(3.0) * tau.max() * kn


def _closure(label, launched, extinct, escaped, lost, bound):
    """launched = extinguished + escaped + lost, per wavelength, to within
    ``bound`` (absolute, per wavelength)."""
    resid = launched - extinct - escaped - lost
    scale = np.maximum(launched, 1e-300)
    check(np.all(np.abs(resid) <= bound),
          f"{label} energy closure: |launched - extinguished - escaped - "
          f"lost| / launched max {np.max(np.abs(resid) / scale):.2e} within "
          f"the bound, max {np.max(bound / scale):.2e} (escaped "
          f"{np.sum(escaped) / np.sum(launched):.3f}, lost "
          f"{np.sum(lost) / np.sum(launched):.3f} of the total)")


@contextlib.contextmanager
def _record_scaspe_march(calls):
    """Record the arguments of the first march call that deposits into
    scaspe, so that its compiled memory use can be read back."""
    from dartray_tpu.rt import march as M

    orig = M.march

    def rec(*a, **k):
        if k.get("scaspe_accum") is not None and not calls:
            calls.append((a, k))
        return orig(*a, **k)

    M.march = rec
    try:
        yield
    finally:
        M.march = orig


def _scaspe_march_memory(call):
    """compiled.memory_analysis() of the scaspe-depositing march: a
    per-iteration copy of the carried scaspe would need a temporary
    buffer as large as scaspe itself."""
    from dartray_tpu.rt import march as M

    a, k = call
    scaspe_b = sum(s.size * s.dtype.itemsize for s in k["scaspe_accum"])
    ma = M.march_legacy.lower(*a, **k).compile().memory_analysis()
    if ma is None:
        print("  scaspe march: memory analysis not available on this "
              "backend", flush=True)
        return
    print(f"  scaspe march (NR={a[6].n}): scaspe {scaspe_b / 2**20:.1f} MiB; "
          f"arguments {ma.argument_size_in_bytes / 2**20:.1f} MiB, outputs "
          f"{ma.output_size_in_bytes / 2**20:.1f} MiB, aliased "
          f"{ma.alias_size_in_bytes / 2**20:.1f} MiB, temporaries "
          f"{ma.temp_size_in_bytes / 2**20:.1f} MiB -> "
          + ("no room for a per-iteration scaspe copy"
             if ma.temp_size_in_bytes < scaspe_b
             else "temporaries could hold a scaspe copy"), flush=True)


# ---------------------------------------------------------------------------
# phase 2: direct light
# ---------------------------------------------------------------------------

def phase_direct(prob: Problem, runs=2, mesh=None, memory=False):
    """Precalc + direct light with scaspe collection + i_obs toward the
    observers, through pipeline.run_direct_light.  Returns (result,
    ScaspeConfig)."""
    import jax
    from dartray_tpu import pipeline as P
    from dartray_tpu.constants import PARSEC
    from dartray_tpu.rt import scattering as SC

    cfg, wl, dust = prob.cfg, prob.wl, prob.dust
    scfg = SC.ScaspeConfig.from_run_config(cfg, dust, wl, prob.dir_out)
    calls = []

    def run():
        rec = (_record_scaspe_march(calls) if memory and not calls
               else contextlib.nullcontext())
        with rec:
            res = P.run_direct_light(
                prob.grid, cfg, wl, dust,
                p_src_pos=prob.src_pos, p_src_lum=prob.src_lum,
                dir_out=prob.dir_out, make_maps=False, collect_scaspe=True,
                scaspe_cfg=scfg, mesh=mesh,
            )
            jax.block_until_ready(res.scaspe)
        return res

    res, walls = _runs(run, runs)
    _report("run_direct_light", walls)
    st = res.stats
    _stage_line("precalc", st, "precalc_")
    _stage_line("direct", st, "direct_")
    rest = walls[-1] - st["precalc_wall_s"] - st["direct_wall_s"]
    print(f"  {'i_obs + SED':12s} {rest:8.3f} s", flush=True)
    ncol = sum(b.npix_tot * len(b.lam_idx) for b in scfg.buckets)
    nhp = sum(b.npix_hp * len(b.lam_idx) for b in scfg.buckets)
    print(f"  scaspe: {ncol} floats per cell ({nhp} HEALPix, "
          f"{ncol - nhp} observer columns) in {len(scfg.buckets)} buckets",
          flush=True)
    if calls:
        _scaspe_march_memory(calls[0])

    lum = prob.src_lum[0]
    d_cm = cfg.dist_obs * PARSEC * 100
    f0 = lum / (4 * np.pi * d_cm**2) * 1e23  # [Jy]
    tau = prob.tau_z * _stellar(prob, dust.kext) / dust.kext_ref
    theta = prob.dir_out[:, 0]
    up, down = int(np.argmin(theta)), int(np.argmax(theta))
    err_up = np.max(np.abs(res.sed_direct[up] / f0 - 1))
    err_dn = np.max(np.abs(res.sed_direct[down] / (f0 * np.exp(-tau)) - 1))
    tol = 1e-4  # float32 attenuation along ~100 cells
    check(err_up < tol,
          f"SED up = L/(4 pi d^2): max rel err {err_up:.2e} < {tol}")
    check(err_dn < tol,
          f"SED down = L e^-tau/(4 pi d^2): max rel err {err_dn:.2e} < {tol}")
    frac = res.lum_lost / lum
    check(np.all(frac < 0.01),
          f"lum_lost / L < 1% at every wavelength: max {frac.max():.2e}")
    leaf = np.asarray(prob.grid.leaf_mask())
    albedo = _stellar(prob, dust.albedo)
    ext = (scfg.lumcell(res.scaspe) * leaf[:, None]).sum(axis=0) / albedo
    _closure("direct", lum, ext, np.asarray(st["direct_lum_esc"]),
             res.lum_lost, 1e-3 * lum + 0.5 * _tau_cell_max(prob)
             * res.lum_lost)
    return res, scfg


# ---------------------------------------------------------------------------
# phase 3: single scattering
# ---------------------------------------------------------------------------

def phase_single_scattering(max_lvl=4, lam=None, runs=2):
    """First-order scattered flux toward the up and down observers: the
    observer stage sourced by the direct scaspe only, against the
    closed-form integral."""
    import jax
    from dartray_tpu import pipeline as P
    from dartray_tpu.constants import PARSEC
    from dartray_tpu.models import trustI
    from dartray_tpu.rt import engine as E
    from dartray_tpu.rt import scattering as SC

    print(f"  run at tau_z = {TAU_SINGLE}, where the check's tolerance was "
          "set", flush=True)
    prob = setup(tau_z=TAU_SINGLE, max_lvl=max_lvl, lam=lam)
    cfg, wl, dust, grid = prob.cfg, prob.wl, prob.dust, prob.grid
    scfg = SC.ScaspeConfig.from_run_config(cfg, dust, wl, prob.dir_out)
    theta = prob.dir_out[:, 0]
    cols = [int(np.argmin(theta)), int(np.argmax(theta))]  # up, down
    csize = np.asarray(grid.csize)
    leaf = np.asarray(grid.leaf_mask())
    d_cm = cfg.dist_obs * PARSEC * 100

    def run():
        direct = P.run_direct_light(
            grid, cfg, wl, dust, p_src_pos=prob.src_pos,
            p_src_lum=prob.src_lum, dir_out=prob.dir_out, make_maps=False,
            collect_scaspe=True, scaspe_cfg=scfg,
        )
        scaspe = SC.ScaspeConfig.asarray(direct.scaspe)
        lumcell = scfg.lumcell(scaspe)
        sel = np.flatnonzero(leaf & (lumcell.sum(axis=1) > 0))
        sources = E.SourceSet(
            pos=np.asarray(grid.ccoord)[sel], cell=sel, sid=sel,
            lum=lumcell[sel], point=False,
        )
        i_obs, _ = E.run_iobs_stage(
            grid, P.make_physics(grid, dust, wl.stellar_slice), sources,
            dir_out=prob.dir_out[cols], n_sid=grid.n_cells + 1,
            src_lum_dir_fn=lambda j, cells: scfg.obs_lum(
                scaspe, cells, cols[j]),
        )
        jax.block_until_ready(direct.u_final)
        return np.stack([
            (i_obs[: grid.n_cells, j] * (csize**2)[:, None]).sum(axis=0)
            / d_cm**2 * 1e23
            for j in range(2)
        ])

    f_jy, walls = _runs(run, runs)
    _report("direct + scattered observer stage", walls)
    tol = 0.08  # ray/beam and cell discretization
    for j, name in enumerate(("up", "down")):
        expect = trustI.single_scattering_flux_jy(
            _stellar(prob, dust.kext) / dust.kext_ref,
            _stellar(prob, dust.albedo), _stellar(prob, dust.gsca),
            prob.src_lum[0], scfg, prob.tau_z, up=(j == 0),
            dist_pc=cfg.dist_obs)
        ratio = f_jy[j] / expect
        check(np.all(np.abs(ratio - 1) < tol),
              f"single scattering {name}: flux / closed form in "
              f"[{ratio.min():.4f}, {ratio.max():.4f}] over "
              f"{len(ratio)} wavelengths, tol {tol}")


# ---------------------------------------------------------------------------
# phase 4: one scattering iteration
# ---------------------------------------------------------------------------

def phase_scattering(prob: Problem, direct, scfg, every=EVERY, runs=2,
                     mesh=None):
    """One scattering iteration sourced by the direct scaspe of every
    `every`-th cell.  Returns the ScatteringResult."""
    import jax
    import jax.numpy as jnp
    from dartray_tpu import pipeline as P
    from dartray_tpu.rt import engine as E
    from dartray_tpu.rt import scattering as SC

    cfg, grid = prob.cfg, prob.grid
    keep = jnp.asarray(np.arange(grid.n_cells) % every == 0)
    sub = tuple(s * keep[:, None, None].astype(s.dtype)
                for s in direct.scaspe)
    phys = P.make_physics(grid, prob.dust, prob.wl.stellar_slice)
    en_lim = E.set_en_lim(grid, cfg.accuracy, len(prob.src_pos))
    leaf = np.asarray(grid.leaf_mask())
    n_src = int(np.sum(leaf[::every] & (scfg.lumcell(sub)[::every].sum(1)
                                        > 0)))
    print(f"  sources: 1 cell in {every}, {n_src} cells", flush=True)

    def run():
        sres = SC.run_scattering(
            grid, phys, scfg, sub, direct.u_final,
            conv_en_lim=cfg.conv_en_lim, en_lim=en_lim,
            bm_par_sca=cfg.bm_par_sca, bm_par_max=cfg.bm_par_max,
            max_iterations=1, chunk=32, mesh=mesh,
        )
        jax.block_until_ready((sres.u_final, sres.scaspe_tot))
        return sres

    sres, walls = _runs(run, runs)
    _report("run_scattering (1 iteration)", walls)
    st = sres.stats
    _stage_line("scattering", st, "scatt_")
    check(sres.iterations == 1, f"one iteration ran ({sres.iterations})")
    u = np.asarray(sres.u_final)
    u0 = np.asarray(direct.u_final)
    check(bool(np.all(np.isfinite(u))) and bool(np.all(u >= u0)),
          f"u finite and not below the direct field: added "
          f"{(u - u0).sum():.3e}")
    launched = (scfg.lumcell(sub) * leaf[:, None]).sum(axis=0)
    new = (scfg.lumcell(sres.scaspe_tot) - scfg.lumcell(sub)) * leaf[:, None]
    albedo = _stellar(prob, prob.dust.albedo)
    _closure("scattering", launched, new.sum(axis=0) / albedo,
             np.asarray(st["scatt_lum_esc"]), sres.lum_lost,
             1e-3 * launched + 0.5 * _tau_cell_max(prob) * sres.lum_lost)
    return sres


# ---------------------------------------------------------------------------
# phase 5: gradient
# ---------------------------------------------------------------------------

def phase_gradient(prob: Problem, direct, scfg, n_sources=GRAD_SOURCES,
                   runs=2):
    """d(sum of i_obs)/d(dens_ref) through replay.replay_iobs on the
    default device, against the CPU backend in float64 on the same
    march traces."""
    import jax
    import jax.numpy as jnp
    from dartray_tpu import pipeline as P
    from dartray_tpu.rt import engine as E
    from dartray_tpu.rt import replay as REP

    grid = prob.grid
    leaf = np.asarray(grid.leaf_mask())
    lumcell = scfg.lumcell(direct.scaspe)
    cells = np.flatnonzero(leaf & (lumcell.sum(axis=1) > 0))
    cells = cells[np.linspace(0, len(cells) - 1,
                              min(n_sources, len(cells))).astype(int)]
    src = E.SourceSet(pos=np.asarray(grid.ccoord)[cells], cell=cells,
                      sid=cells, lum=lumcell[cells], point=False)
    th, ph = prob.dir_out[len(prob.dir_out) // 3]  # an oblique observer
    phys = P.make_physics(grid, prob.dust, prob.wl.stellar_slice)
    traces, i_march = E.trace_iobs_rays(
        grid, phys, src, np.full(src.n, th), np.full(src.n, ph))
    print(f"  {src.n} rays toward theta={th:.4f}, up to "
          f"{int(traces['count'].max())} intersections each", flush=True)

    def value_and_grad(fdtype):
        args = (
            jnp.asarray(phys.kext_norm, fdtype), jnp.asarray(src.lum, fdtype),
            jnp.asarray(traces["cells"]), jnp.asarray(traces["lengths"],
                                                      fdtype),
            jnp.asarray(traces["count"]), jnp.asarray(traces["src_cell"]),
            jnp.asarray(traces["csize_nc"], fdtype),
        )

        def objective(dens):
            i = REP.replay_iobs(dens, *args, point_source=False,
                                own_full_cell=True)
            return jnp.sum(i), i

        (val, i), g = jax.value_and_grad(objective, has_aux=True)(
            jnp.asarray(grid.dens_ref, fdtype))
        return float(val), np.asarray(i), np.asarray(g)

    fdt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    (val, i_rep, g), walls = _runs(lambda: value_and_grad(fdt), runs)
    _report(f"value_and_grad on {jax.devices()[0].platform}", walls)
    cpu = jax.devices("cpu")[0]
    t = time.perf_counter()
    with jax.enable_x64(True), jax.default_device(cpu):
        val64, i64, g64 = value_and_grad(jnp.float64)
    print(f"  reference on the CPU backend in float64: "
          f"{time.perf_counter() - t:.3f} s", flush=True)

    nz = i_march > 0
    err_m = np.max(np.abs(i_rep[nz] / i_march[nz] - 1))
    check(err_m < 1e-5,
          f"replay i_obs == march i_obs: max rel diff {err_m:.2e} < 1e-05")
    err_v = abs(val / val64 - 1)
    check(err_v < 1e-5,
          f"sum of i_obs vs CPU float64: rel diff {err_v:.2e} < 1e-05")
    err_g = np.max(np.abs(g - g64)) / np.max(np.abs(g64))
    check(err_g < 1e-4,
          f"d sum(i_obs) / d dens vs CPU float64: max abs diff / max |grad| "
          f"{err_g:.2e} < 1e-04 over {int(np.sum(g64 != 0))} cells")


# ---------------------------------------------------------------------------
# phase 6: stochastic heating
# ---------------------------------------------------------------------------

def phase_sto(runs=2):
    """One stochastic-emission solve for three small grains in three
    radiation fields, in a float32 session (the solve itself runs in
    float64 on the default device), against the CPU backend."""
    import jax
    from dartray_tpu import dust as D
    from dartray_tpu import sto
    from dartray_tpu.wavelength import make_wavelength_grid

    lam = np.concatenate([np.logspace(-1.5, 0.4, 14), np.logspace(0.5, 3, 18)])
    wl = make_wavelength_grid(lam, max_lambda_stars=2.6, min_lambda_dust=1.0)
    sizes = np.array([[3e-9, 1e-8, 3e-8]])
    n = wl.lnum_tot
    # one gray species (Qabs = 1): small enough for the full P(T) solve
    dm = D.DustModel(
        lambda_um=wl.lambda_um, kabs=np.full(n, 1e-13),
        ksca=np.full(n, 1e-14), kext=np.full(n, 1.1e-13), gsca=np.zeros(n),
        kext_ref=1e-13, tau_nh_ref=1e-25, dust_size_fa=sizes,
        dust_fa=np.full((1, 3), 1e5), delta_dust_size=np.full((1, 3), 1e-8),
        qabs_fa=np.ones((1, 3, n)), n_dust_size=np.array([3]),
    )
    cal = D.add_planck_avg_qabs(
        D.load_calorimetry(os.path.join(DATA, "DUST_OPACITY"), n_comp=1),
        dm, wl.lambda_si, wl.delta_lambda_bin)
    rf = np.stack([np.full(wl.lnum_stars, v) for v in (1e1, 1e2, 1e3)])

    def run():
        with jax.enable_x64(False):
            return sto.stochastic_emission(dm, cal, wl, rf, n_temp_pt=120,
                                           grain_chunk=4)

    res, walls = _runs(run, runs)
    _report(f"stochastic_emission on {jax.devices()[0].platform}", walls)
    t = time.perf_counter()
    with jax.default_device(jax.devices("cpu")[0]):
        ref = sto.stochastic_emission(dm, cal, wl, rf, n_temp_pt=120,
                                      grain_chunk=4)
    print(f"  reference on the CPU backend: {time.perf_counter() - t:.3f} s",
          flush=True)
    check(res.n_full == ref.n_full and res.n_full > 0,
          f"full P(T) solves: {res.n_full} here, {ref.n_full} on the CPU")
    err = np.max(np.abs(res.sed - ref.sed) / np.max(np.abs(ref.sed), axis=1,
                                                    keepdims=True))
    check(err < 1e-6,
          f"SED vs CPU float64: max abs diff / peak {err:.2e} < 1e-06")


# ---------------------------------------------------------------------------
# --four: multi-process and mesh runs of phases 2 and 4
# ---------------------------------------------------------------------------

def _result_arrays(direct, sres):
    out = dict(u_direct=np.asarray(direct.u_final, np.float32),
               i_obs=np.asarray(direct.i_obs, np.float32),
               u_scatt=np.asarray(sres.u_final, np.float32))
    for k, s in enumerate(direct.scaspe):
        out[f"scaspe_direct_{k}"] = np.asarray(s, np.float32)
    for k, s in enumerate(sres.scaspe_tot):
        out[f"scaspe_tot_{k}"] = np.asarray(s, np.float32)
    return out


def mesh_runs(prob: Problem, every=EVERY_FOUR, devices=None):
    """Phases 2 and 4 on one card, on a 4-card 'rays' mesh and on a 2 x 2
    'rays' x 'wave' mesh.  Returns {name: arrays}."""
    import jax
    from dartray_tpu.parallel import mesh as PM

    devices = devices or jax.devices()[:4]
    out = {}
    for name, mesh in (("one_card", None),
                       ("rays4", PM.ray_mesh(devices=devices)),
                       ("rays2_wave2", PM.make_mesh(2, 2, devices=devices))):
        print(f"== {name}", flush=True)
        direct, scfg = phase_direct(prob, runs=1, mesh=mesh)
        sres = phase_scattering(prob, direct, scfg, every, runs=1, mesh=mesh)
        out[name] = _result_arrays(direct, sres)
    return out


def compare_runs(name, ref, other):
    """Sharded or multi-process results against one card.  The deposits
    are the same but summed in another order (atomics, per-device replicas
    reduced once per stage), and a multi-process run regroups its share
    of the rays in rounds of its own, which may pair split rays for a
    merge differently: totals agree to 1e-4, cells to 1e-3 of the largest
    cell."""
    worst_tot = worst_cell = 0.0
    for key, b in ref.items():
        a = other[key]
        if a.shape != b.shape:
            raise AssertionError(f"{name} {key}: shape {a.shape} != {b.shape}")
        b64, a64 = b.astype(np.float64), a.astype(np.float64)
        axes = tuple(range(b.ndim - 1))  # per wavelength
        tb, ta = b64.sum(axis=axes), a64.sum(axis=axes)
        tot = np.max(np.abs(ta - tb) / np.maximum(np.abs(tb), 1e-300))
        cell = np.max(np.abs(a64 - b64)) / max(np.max(np.abs(b64)), 1e-300)
        worst_tot, worst_cell = max(worst_tot, tot), max(worst_cell, cell)
        print(f"  {name:12s} {key:16s} totals {tot:.2e}  cells {cell:.2e}",
              flush=True)
    check(worst_tot < 1e-4 and worst_cell < 1e-3,
          f"{name} == one card: totals within {worst_tot:.2e} < 1e-04, "
          f"cells within {worst_cell:.2e} < 1e-03 of the largest")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _wait(procs, timeout):
    logs = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return logs


def run_four():
    """Parent of the --four run: stays off JAX, so that every card is free
    for the processes it starts."""
    print(f"nvidia-smi: {runtime.gpu_name_power()}", flush=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_four_")
    try:
        port = _free_port()
        procs = []
        for rank in range(4):
            env = dict(os.environ, DARTRAY_MULTIHOST="1",
                       DARTRAY_COORDINATOR=f"localhost:{port}",
                       DARTRAY_NUM_PROCS="4", DARTRAY_PROC_ID=str(rank))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 "multihost", "--out", tmp],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        t = time.perf_counter()
        logs = _wait(procs, 420)
        print(f"== 4 processes, one card each (DARTRAY_MULTIHOST=1): "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        print(logs[0], end="", flush=True)
        for rank, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                print(log[-4000:], flush=True)
                raise AssertionError(f"process {rank} exited {p.returncode}")
        t = time.perf_counter()
        mesh = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", "mesh",
             "--out", tmp],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log = _wait([mesh], 720)[0]
        print(f"== one process, four cards: {time.perf_counter() - t:.1f} s",
              flush=True)
        print(log, end="", flush=True)
        if mesh.returncode != 0:
            raise AssertionError(f"mesh process exited {mesh.returncode}")
        ref = dict(np.load(os.path.join(tmp, "one_card.npz")))
        print("== comparisons with one card", flush=True)
        for name in ("rays4", "rays2_wave2", "multihost"):
            compare_runs(name, ref, dict(np.load(os.path.join(tmp,
                                                              name + ".npz"))))
        with open(os.path.join(tmp, "device.json")) as f:
            device = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"nvidia-smi: {runtime.gpu_name_power()}", flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)


def _worker(kind, out_dir):
    if kind == "multihost":
        from dartray_tpu.parallel import distributed as DIST

        DIST.initialize()  # DARTRAY_COORDINATOR / _NUM_PROCS / _PROC_ID
    runtime.setup_compile_cache()
    import jax

    runtime.require_gpu()
    prob = setup()
    if kind == "multihost":
        if jax.process_count() != 4 or len(jax.local_devices()) != 1:
            raise AssertionError(
                f"{jax.process_count()} processes with "
                f"{len(jax.local_devices())} local devices; want 4 x 1")
        direct, scfg = phase_direct(prob, runs=1)
        sres = phase_scattering(prob, direct, scfg, EVERY_FOUR, runs=1)
        if jax.process_index() == 0:
            np.savez(os.path.join(out_dir, "multihost.npz"),
                     **_result_arrays(direct, sres))
        return
    if len(jax.devices()) != 4:
        raise AssertionError(f"{len(jax.devices())} devices; want 4")
    for name, arrays in mesh_runs(prob).items():
        np.savez(os.path.join(out_dir, name + ".npz"), **arrays)
    with open(os.path.join(out_dir, "device.json"), "w") as f:
        json.dump(runtime.device_info(), f)


# ---------------------------------------------------------------------------
# one card
# ---------------------------------------------------------------------------

def run_one():
    cache = runtime.setup_compile_cache()
    import jax

    runtime.require_gpu()
    dev = jax.devices()[0]
    print(f"device: platform={dev.platform} kind={dev.device_kind} "
          f"count={len(jax.devices())} jax={jax.__version__} "
          f"x64={jax.config.jax_enable_x64}", flush=True)
    print(f"nvidia-smi: {runtime.gpu_name_power()}", flush=True)
    n_cached = sum(len(f) for _, _, f in os.walk(cache))
    print(f"compile cache: {cache} ({n_cached} files at start)", flush=True)
    t_all = time.perf_counter()

    def phase(n, title, fn):
        print(f"== phase {n}: {title}", flush=True)
        t = time.perf_counter()
        out = fn()
        print(f"== phase {n}: {time.perf_counter() - t:.1f} s, peak device "
              f"memory {_peak_memory()}", flush=True)
        return out

    prob = phase(1, "setup", lambda: setup())
    print(f"  TRUST I tau_z={prob.tau_z}: {prob.grid.n_cells} cells, "
          f"L={prob.wl.lnum_stars}, {len(prob.dir_out)} observers", flush=True)
    direct, scfg = phase(2, "direct light",
                         lambda: phase_direct(prob, memory=True))
    phase(3, "single scattering", phase_single_scattering)
    phase(4, "scattering iteration",
          lambda: phase_scattering(prob, direct, scfg))
    phase(5, "gradient", lambda: phase_gradient(prob, direct, scfg))
    phase(6, "stochastic heating", phase_sto)
    print(f"== all phases: {time.perf_counter() - t_all:.1f} s", flush=True)
    print(f"nvidia-smi: {runtime.gpu_name_power()}", flush=True)
    print(json.dumps({"ok": True, "device": runtime.device_info()}),
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="four cards: multi-process and mesh runs")
    ap.add_argument("--worker", choices=("multihost", "mesh"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        _worker(args.worker, args.out)
    elif args.four:
        run_four()
    else:
        run_one()
    return 0


if __name__ == "__main__":
    sys.exit(main())
