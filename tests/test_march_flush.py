"""Two-level march loop (flush_every) equivalence.

The two-level variant moves the u/scaspe scatter-adds out of the
while_loop body: an inner lax.scan of K steps records the (cell, value)
deposit entries and the outer body flushes them in batched scatter-adds
(march.flush_every).  Physics is identical — only the summation order of
the deposits changes — so every field must match the single-level loop to
float tolerance, and the blocking/status machinery (which never moved)
must match exactly.

Chained scatters on one array inside a loop body have been miscompiled
before, silently corrupting state, so this equivalence suite guards the
chained per-segment flush scatters.
"""
import numpy as np
import pytest
import jax.numpy as jnp

from dartray_tpu.grid import build_grid
from dartray_tpu.rt import engine as E
from dartray_tpu.rt import march as M
from dartray_tpu.rt import rays as R
from dartray_tpu.rt import scattering as SC


def lumpy_grid(base=(6, 2), max_lvl=3, modelsize=10.0):
    """Non-uniform medium with refinement so rays block/split/merge."""

    def dens_fn(centers, csize):
        r2 = np.sum(centers**2, axis=1)
        dens = 0.4 * np.exp(-r2 / 8.0) + 0.02
        return dens, np.zeros(len(centers))

    def subdiv(centers, csize, level, dens, dens_stars):
        return (np.abs(centers) < 2.0).all(axis=1) & (level < max_lvl)

    return build_grid(dens_fn, subdiv, base=base, max_lvl=max_lvl, min_lvl=1,
                      modelsize=modelsize, max_ncell=200_000)


def physics(grid, L=3, albedo=0.5, gsca=0.6):
    return E.Physics(
        dens_ref=jnp.asarray(grid.dens_ref),
        kext_norm=jnp.asarray(np.linspace(1.0, 0.5, L)),
        albedo=jnp.full(L, albedo),
        gsca=jnp.asarray(np.linspace(gsca, 0.0, L)),
        cs=1.0,
        lambda_um=np.linspace(0.3, 2.0, L),
    )


@pytest.fixture(scope="module")
def setup():
    grid = lumpy_grid()
    phys = physics(grid)
    src = E.point_source_set(
        grid, np.array([[0.31, -0.17, 0.23]]), np.array([[1.0, 0.8, 0.6]])
    )
    return grid, phys, src


def _stage(grid, phys, src, flush_k, monkeypatch, **kw):
    monkeypatch.setenv("DARTRAY_FLUSH_K", str(flush_k))
    return E.run_field_stage(grid, phys, src, **kw)


def test_precalc_flush_equivalence(setup, monkeypatch):
    grid, phys, src = setup
    kw = dict(mode=M.MODE_PRECALC, rad_lim=2.0, bm_par=10, bm_par_max=200)
    r0 = _stage(grid, phys, src, 0, monkeypatch, **kw)
    r8 = _stage(grid, phys, src, 8, monkeypatch, **kw)
    assert r0.stats["rays"] == r8.stats["rays"]
    assert r0.stats["steps"] == r8.stats["steps"]
    np.testing.assert_allclose(
        np.asarray(r8.u), np.asarray(r0.u), rtol=1e-12, atol=1e-300
    )


def test_direct_scaspe_flush_equivalence(setup, monkeypatch):
    """Direct stage with scattering deposits: u, scaspe, lum_lost and the
    ray/step counts must match between the single-level and two-level
    loops."""
    grid, phys, src = setup
    pre = _stage(grid, phys, src, 0, monkeypatch, mode=M.MODE_PRECALC,
                 rad_lim=2.0, bm_par=10, bm_par_max=200)
    scfg = SC.ScaspeConfig.make(1, np.asarray(phys.gsca),
                                np.array([[0.4, 1.1]]))
    kw = dict(
        mode=M.MODE_DIRECT, u_fest=pre.u,
        en_lim=E.set_en_lim(grid, 0.2, 1), bm_par=10, bm_par_max=200,
        scaspe_cfg=scfg,
    )
    r0 = _stage(grid, phys, src, 0, monkeypatch,
                scaspe_init=scfg.zeros(grid.n_cells, jnp.float64), **kw)
    r8 = _stage(grid, phys, src, 8, monkeypatch,
                scaspe_init=scfg.zeros(grid.n_cells, jnp.float64), **kw)
    assert r0.stats["rays"] == r8.stats["rays"]
    assert r0.stats["steps"] == r8.stats["steps"]
    np.testing.assert_allclose(
        np.asarray(r8.u), np.asarray(r0.u), rtol=1e-12, atol=1e-300
    )
    np.testing.assert_allclose(r8.lum_lost, r0.lum_lost, rtol=1e-12)
    for s8, s0 in zip(r8.scaspe, r0.scaspe):
        np.testing.assert_allclose(
            np.asarray(s8), np.asarray(s0), rtol=1e-12, atol=1e-300
        )
    # the deposits actually fired (non-trivial equivalence)
    assert float(sum(jnp.sum(s) for s in r8.scaspe)) > 0


def test_flush_partial_segment(setup, monkeypatch):
    """A flush_k that does not divide the step count exactly (the tail
    segment runs masked steps) must still be exact."""
    grid, phys, src = setup
    kw = dict(mode=M.MODE_PRECALC, rad_lim=2.0, bm_par=10, bm_par_max=200)
    r0 = _stage(grid, phys, src, 0, monkeypatch, **kw)
    r7 = _stage(grid, phys, src, 7, monkeypatch, **kw)
    assert r0.stats["steps"] == r7.stats["steps"]
    np.testing.assert_allclose(
        np.asarray(r7.u), np.asarray(r0.u), rtol=1e-12, atol=1e-300
    )


def test_scattering_iteration_flush_equivalence(setup, monkeypatch):
    """One full scattering iteration through run_scattering matches
    between the loop modes (exercises src_lum_fn + device scaspe reads +
    the two-level deposit path together)."""
    grid, phys, src = setup
    pre = _stage(grid, phys, src, 0, monkeypatch, mode=M.MODE_PRECALC,
                 rad_lim=2.0, bm_par=10, bm_par_max=200)
    scfg = SC.ScaspeConfig.make(1, np.asarray(phys.gsca), None)
    en_lim = E.set_en_lim(grid, 0.2, 1)

    def direct(flush_k):
        return _stage(
            grid, phys, src, flush_k, monkeypatch, mode=M.MODE_DIRECT,
            u_fest=pre.u, en_lim=en_lim, bm_par=10, bm_par_max=200,
            scaspe_cfg=scfg,
            scaspe_init=scfg.zeros(grid.n_cells, jnp.float64),
        )

    outs = {}
    for fk in (0, 8):
        monkeypatch.setenv("DARTRAY_FLUSH_K", str(fk))
        d = direct(fk)
        sres = SC.run_scattering(
            grid, phys, scfg, d.scaspe, d.u, conv_en_lim=0.01,
            en_lim=en_lim, bm_par_sca=5, bm_par_max=200, max_iterations=1,
        )
        outs[fk] = sres
    np.testing.assert_allclose(
        np.asarray(outs[8].u_final), np.asarray(outs[0].u_final),
        rtol=1e-12, atol=1e-300,
    )
    for s8, s0 in zip(outs[8].scaspe_tot, outs[0].scaspe_tot):
        np.testing.assert_allclose(
            np.asarray(s8), np.asarray(s0), rtol=1e-12, atol=1e-300
        )
