"""Scattering source function ("scaspe") and scattering iterations.

Rebuild of create_scaspe / set_npix_arr / calc_ffn_arr / assign_src_lum and
the rtt_scatt iteration loop (rt_routines.f90:2784-2852, 5235-5315,
2186-2281, 3043-3071; dartray_hub.f90:45-52).

Layout: per-wavelength adaptive angular resolution exactly like the
reference's set_npix_arr (rt_routines.f90:5235-5315) — kp(lambda) chosen so
>= 5 HEALPix pixels sample the Henyey-Greenstein FWHM, capped at kp_sca_max,
and a single pixel for isotropic wavelengths (|g| < 2e-3).  Wavelengths are
grouped into *kp buckets* (the reference's npix_unique grouping,
rt:5281-5311): the scattering source function is a tuple of dense tensors,
one per bucket, of shape (ncell, npix_hp_k + tot_ndir, L_k).  This is both
the memory lever (isotropic IR wavelengths cost 1 pixel, not 12*4^kp) and
the deposit-throughput lever (the per-step scatter-add shrinks by the same
factor).

The Henyey-Greenstein deposition weights (calc_ffn_arr) depend only on the
*ray direction* — constant along a ray — so they are computed once per march
kernel call, outside the traversal loop.

The scattering iterations run in the reference's sequential_scattering
(Jacobi) mode (rt_routines.f90:272): each iteration propagates the
luminosity scattered in the *previous* pass; this is order-independent,
which is what a data-parallel pass needs (no_communications mode
requires it in the reference too, rt:319).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .. import healpix as hp
from ..grid.octree import Grid
from . import march as M
from . import engine as E

G_ISO_THRESHOLD = 2e-3  # g_th (rt_routines.f90:5246)
NMIN_FWHM = 5  # pixels within the HG FWHM (rt:5244)


def npix_plan(gsca, kp_sca_max: int):
    """Per-wavelength HEALPix k parameter for the scaspe arrays
    (set_npix_arr, rt_routines.f90:5235-5315).

    Returns (kp_arr (L,) int, npix_hp_arr (L,) int); kp = -1 marks isotropic
    wavelengths (|g| < 2e-3) which get a single pixel."""
    g = np.abs(np.asarray(gsca, dtype=np.float64))
    kp = np.full(g.shape, -1, dtype=np.int64)
    npix = np.ones(g.shape, dtype=np.int64)
    aniso = g >= G_ISO_THRESHOLD
    ga = np.where(aniso, g, 0.5)  # placeholder to keep formulas finite
    pmax = (1 - ga**2) / (1 + ga**2 - 2 * ga) ** 1.5
    pmin = (1 - ga**2) / (1 + ga**2 + 2 * ga) ** 1.5
    cos_hm = ((2 * (1 - ga**2) / (pmax + pmin)) ** (2.0 / 3.0) - (1 + ga**2)) / (
        -2 * ga
    )
    fwhm = 2 * np.arccos(np.clip(cos_hm, -1.0, 1.0))
    delta_min = fwhm / NMIN_FWHM
    k_min = (
        1.0 / (2 * np.log10(2.0)) * np.log10(4 * np.pi / (12 * delta_min**2))
    ).astype(np.int64)  # int() truncation as in the reference
    k_min = np.minimum(k_min, kp_sca_max)
    kp = np.where(aniso, k_min, kp)
    npix = np.where(aniso, 12 * 4**np.maximum(k_min, 0), npix)
    return kp, npix


@dataclasses.dataclass
class ScaspeBucket:
    kp: int  # HEALPix k parameter; -1 = isotropic (1 pixel)
    npix_hp: int  # HEALPix pixels (1 for isotropic)
    lam_idx: np.ndarray  # (L_k,) wavelength indices into the range's L axis
    dirs: np.ndarray  # (npix_hp + ndir, 3) unit vectors (pixel centers + observers)

    @property
    def nside(self):
        return 2 ** max(self.kp, 0)

    @property
    def npix_tot(self):
        return self.dirs.shape[0]


@dataclasses.dataclass
class ScaspeConfig:
    kp_arr: np.ndarray  # (L,) per-wavelength kp (-1 = isotropic)
    npix_hp_arr: np.ndarray  # (L,)
    buckets: list  # [ScaspeBucket]
    tot_ndir: int
    L: int

    @classmethod
    def make(cls, kp_sca_max: int, gsca, dir_out=None):
        gsca = np.asarray(gsca, dtype=np.float64)
        L = gsca.shape[0]
        kp_arr, npix_hp_arr = npix_plan(gsca, kp_sca_max)
        if dir_out is not None and len(dir_out) > 0:
            do = np.asarray(dir_out, dtype=np.float64)
            ndir = len(do)
        else:
            do = np.zeros((0, 2))
            ndir = 0
        buckets = []
        for kp in sorted(set(kp_arr.tolist())):
            lam_idx = np.flatnonzero(kp_arr == kp)
            if kp >= 0:
                nside = 2**kp
                nhp = 12 * nside * nside
                th, ph = hp.np_pix2ang_nest(nside, np.arange(nhp))
                th = np.asarray(th)
                ph = np.asarray(ph)
            else:
                nhp = 1
                # single pixel: direction irrelevant (weight is uniform)
                th = np.zeros(1)
                ph = np.zeros(1)
            th = np.concatenate([th, do[:, 0]])
            ph = np.concatenate([ph, do[:, 1]])
            dirs = np.stack(
                [np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph), np.cos(th)],
                axis=-1,
            )
            buckets.append(
                ScaspeBucket(kp=int(kp), npix_hp=nhp, lam_idx=lam_idx, dirs=dirs)
            )
        return cls(
            kp_arr=kp_arr, npix_hp_arr=npix_hp_arr, buckets=buckets,
            tot_ndir=ndir, L=L,
        )

    @classmethod
    def from_run_config(cls, cfg, dust, wl, dir_out=None, lambda_range="stars"):
        sl = wl.stellar_slice if lambda_range == "stars" else wl.dust_slice
        return cls.make(cfg.kp_sca_max, dust.gsca[sl], dir_out)

    # ---- storage ----
    def zeros(self, ncell: int, fdtype) -> tuple:
        return tuple(
            jnp.zeros((ncell, b.npix_tot, len(b.lam_idx)), dtype=fdtype)
            for b in self.buckets
        )

    def lam_idx_tuple(self) -> tuple:
        return tuple(jnp.asarray(b.lam_idx, dtype=jnp.int32) for b in self.buckets)

    @staticmethod
    def add(a: tuple, b: tuple) -> tuple:
        return tuple(x + y for x, y in zip(a, b))

    @staticmethod
    def asarray(a: tuple) -> tuple:
        return tuple(np.asarray(x) for x in a)

    def nbytes(self, ncell: int, itemsize: int = 8) -> int:
        return sum(
            ncell * b.npix_tot * len(b.lam_idx) * itemsize for b in self.buckets
        )

    # ---- per-batch HG deposition weights (calc_ffn_arr, rt:2186-2281) ----
    def ffn(self, theta, phi, gsca) -> tuple:
        """Precomputed deposition weights per bucket: (NR, P_k, L_k).

        For anisotropic buckets the HG phase value at each scaspe direction,
        normalized over the npix_hp HEALPix pixels (observer pixels get the
        same normalized values, rt:2258-2266); for the isotropic bucket a
        uniform 1/npix_hp = 1 (rt:2270)."""
        theta = np.asarray(theta)
        phi = np.asarray(phi)
        g_all = np.asarray(gsca)
        st = np.sin(theta)
        d = np.stack([st * np.cos(phi), st * np.sin(phi), np.cos(theta)], axis=-1)
        out = []
        for b in self.buckets:
            Lk = len(b.lam_idx)
            if b.kp < 0:
                out.append(np.ones((len(theta), b.npix_tot, Lk)))
                continue
            ads = d @ b.dirs.T  # (NR, P_k)
            g = g_all[b.lam_idx][None, None, :]  # (1, 1, L_k)
            w = (1.0 - g**2) / b.npix_hp * (
                1.0 + g**2 - 2.0 * g * ads[:, :, None]
            ) ** (-1.5)
            tot = np.sum(w[:, : b.npix_hp, :], axis=1, keepdims=True)
            out.append(w / np.maximum(tot, 1e-300))
        return tuple(out)

    def ffn_fn(self, phys):
        """(batch_dict, nside) -> tuple of per-bucket ffn for march()."""
        gs = np.asarray(phys.gsca)

        def fn(d, nside):
            return self.ffn(d["theta"], d["phi"], gs)

        return fn

    # ---- reads ----
    def lumcell(self, scaspe: tuple) -> np.ndarray:
        """Per-cell scattered luminosity (sum over the HEALPix pixels) as a
        dense (ncell, L) array."""
        ncell = np.asarray(scaspe[0]).shape[0]
        out = np.zeros((ncell, self.L))
        for b, s in zip(self.buckets, scaspe):
            out[:, b.lam_idx] = np.asarray(
                jnp.sum(s[:, : b.npix_hp, :], axis=1)
            )
        return out

    def assign_src_lum(self, scaspe: tuple, cells, theta, phi) -> np.ndarray:
        """Ray launch luminosity for scattered light: scaspe value at the ray
        direction times npix_hp (assign_src_lum, rt_routines.f90:3043-3071)."""
        cells = np.asarray(cells)
        out = np.zeros((len(cells), self.L))
        for b, s in zip(self.buckets, scaspe):
            if b.kp >= 0:
                pix = hp.np_ang2pix_nest(b.nside, theta, phi)
            else:
                pix = np.zeros(len(cells), dtype=np.int64)
            out[:, b.lam_idx] = np.asarray(s)[cells, pix, :] * b.npix_hp
        return out

    def obs_lum(self, scaspe: tuple, cells, j: int) -> np.ndarray:
        """Scattered luminosity toward appended observer direction j
        (rt_loop_iobs source, rt_routines.f90:1519-1548)."""
        cells = np.asarray(cells)
        out = np.zeros((len(cells), self.L))
        for b, s in zip(self.buckets, scaspe):
            out[:, b.lam_idx] = np.asarray(s)[cells, b.npix_hp + j, :] * b.npix_hp
        return out

    def dev_ops(self) -> "ScaspeDevOps":
        """Device-side read helpers (cached); see ScaspeDevOps."""
        ops = getattr(self, "_dev_ops", None)
        if ops is None:
            ops = ScaspeDevOps(self)
            object.__setattr__(self, "_dev_ops", ops)
        return ops


class ScaspeDevOps:
    """On-device scaspe reads for the scattering iterations.

    The scaspe tuple stays device-resident, so no launch packet runs
    assign_src_lum as numpy fancy-indexing over a host copy; the only
    per-iteration transfers are the (L,) convergence totals and one
    (ncell,) per-cell sum for source selection, and per launch packet a
    small (n,)+(nb,n) int upload for the gather indices
    (assign_src_lum, rt_routines.f90:3043-3071)."""

    def __init__(self, scfg: "ScaspeConfig"):
        self.scfg = scfg
        idx = np.concatenate([b.lam_idx for b in scfg.buckets])
        inv = np.argsort(idx).astype(np.int32)
        nhp = tuple(b.npix_hp for b in scfg.buckets)

        @jax.jit
        def _lumcell(scaspe, leaf):
            cols = [
                jnp.sum(s[:, :h, :], axis=1) for s, h in zip(scaspe, nhp)
            ]
            lc = jnp.concatenate(cols, axis=1)[:, inv]
            lc = lc * leaf[:, None]
            return lc, jnp.sum(lc, axis=0), jnp.sum(lc, axis=1)

        self._lumcell = _lumcell

        @jax.jit
        def _gather(scaspe, cells, pixs):
            outs = [
                s[cells, pixs[k], :] * h
                for k, (s, h) in enumerate(zip(scaspe, nhp))
            ]
            return jnp.concatenate(outs, axis=1)[:, inv]

        self._gather = _gather

    def lumcell(self, scaspe: tuple, leaf_dev):
        """(lumcell (ncell,L) dev, per-λ totals (L,) dev, per-cell sums
        (ncell,) dev), leaf-masked."""
        return self._lumcell(scaspe, leaf_dev)

    def src_lum(self, scaspe: tuple, cells, theta, phi):
        """Device (n, L) launch luminosity for scattered rays: the scaspe
        value at the ray direction times npix_hp."""
        from . import rays as R

        cells = np.asarray(cells)
        n = len(cells)
        m = R._bucket(n)
        cells_p = np.zeros(m, dtype=np.int32)
        cells_p[:n] = cells
        pixs = np.zeros((len(self.scfg.buckets), m), dtype=np.int32)
        for k, b in enumerate(self.scfg.buckets):
            if b.kp >= 0:
                pixs[k, :n] = hp.np_ang2pix_nest(b.nside, theta, phi)
        out = self._gather(scaspe, jnp.asarray(cells_p), jnp.asarray(pixs))
        return out[:n]

    # NOTE: no device obs_lum counterpart on purpose — the observer-
    # intensity stage runs after the iterations, when scaspe_tot is
    # already on host for the output files; host fancy-indexing there is
    # cheaper than a per-packet device gather dispatch.


@dataclasses.dataclass
class ScatteringResult:
    u_final: jax.Array  # (ncell, L) total field incl. scattered light
    scaspe_tot: tuple  # per-bucket total scattering source function
    iterations: int
    converged: bool
    lum_lost: np.ndarray
    tot_rad_en: np.ndarray  # (L,) total scattered luminosity pool
    stats: dict


def run_scattering(
    grid: Grid,
    phys,
    scfg: ScaspeConfig,
    scaspe_direct,  # per-bucket tuple from the direct-light pass
    u_final,  # (ncell, L) field after direct light
    *,
    conv_en_lim: float = 0.01,
    en_lim: float = 0.0,
    bm_par_sca: float = 5.0,
    bm_par_max: float = 200.0,
    max_iterations: int = 1000,
    wall_lo=(-np.inf,) * 3,
    wall_hi=(np.inf,) * 3,
    chunk: int = 32,
    fdtype=None,
    sym=None,  # rt.symmetry.SymmetryMaps: 2D octant-symmetry mode
    mesh=None,  # jax.sharding.Mesh: shard each iteration over 'rays'
) -> ScatteringResult:
    """Scattered-light iterations (the rtt_scatt loop, dartray_hub.f90:45-52).

    Each iteration: every cell with scattered luminosity re-emits it with
    the angular distribution stored in scaspe_prev; deposits add to u_final
    and to a fresh scaspe accumulator (the next iteration's source).
    Convergence when the remaining pool is < conv_en_lim of the total
    (calc_total_luminosity_sca, rt_routines.f90:663-775).

    With `sym` set (2D mode), each iteration runs the strictly-positive
    octant sources first, symmetrizes the new field delta and the new
    scaspe (fix_symmetry_part3, rt_routines.f90:3802-4080), then runs the
    on-axis sources normally.
    """
    if fdtype is None:
        fdtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    L = np.asarray(phys.kext_norm).shape[0]
    stats: dict = {}
    lum_lost = np.zeros(L)
    perms = None
    if sym is not None:
        from . import symmetry as SYM

        perms = SYM.scaspe_perms(scfg)

    scaspe_prev = tuple(jnp.asarray(s, dtype=fdtype) for s in scaspe_direct)
    scaspe_tot = scaspe_prev
    u = jnp.asarray(u_final, dtype=fdtype)

    leaf = np.asarray(grid.leaf_mask())
    leaf_dev = jnp.asarray(leaf, dtype=fdtype)
    ops = scfg.dev_ops()

    # total scattered luminosity at iteration 1 (rt_routines.f90:675-695)
    _, tot0_dev, _ = ops.lumcell(scaspe_prev, jnp.ones_like(leaf_dev))
    tot_rad_en = np.asarray(tot0_dev, dtype=np.float64)

    converged = False
    it = 0
    while it < max_iterations:
        it += 1
        # per-cell escaping luminosity (lumcell, rt:697-708); scaspe stays
        # on device — only the (L,) totals and the (ncell,) per-cell sums
        # come to host
        lc_dev, totl_dev, percell_dev = ops.lumcell(scaspe_prev, leaf_dev)
        tot_lumcell = np.asarray(totl_dev, dtype=np.float64)
        if tot_rad_en.sum() <= 0:
            converged = True
            break
        frac = np.where(tot_rad_en > 0, tot_lumcell / np.maximum(tot_rad_en, 1e-300), 0.0)
        if np.all(frac < conv_en_lim):
            converged = True
            break

        sel = np.flatnonzero(np.asarray(percell_dev) > 0)
        if sym is not None:
            passes = [
                (np.intersect1d(sel, sym.src_octant), True),
                (np.intersect1d(sel, sym.src_axis), False),
            ]
        else:
            passes = [(sel, False)]

        def src_lum_fn(d, nside):
            # on-device scaspe gather (assign_src_lum, rt:3043-3071)
            return ops.src_lum(
                scaspe_prev, d["src_cell"], d["theta"], d["phi"]
            )

        scaspe_new = scfg.zeros(grid.n_cells, fdtype)
        u_fest_iter = u  # rt_prepare@scatt: u_fest <- u_final (hub:403-417)
        for sel_p, symmetrize in passes:
            if len(sel_p) == 0:
                continue
            sources = E.SourceSet(
                pos=np.asarray(grid.ccoord)[sel_p],
                cell=sel_p,
                sid=sel_p,
                # placeholder only: src_lum_fn overrides every fresh ray's
                # luminosity from scaspe_prev.  MUST be host numpy — a
                # device array here means a per-chunk device slice whose
                # varying bounds recompile on every launch packet
                lum=np.zeros((len(sel_p), L)),
                point=False,
            )
            u_base = u if symmetrize else None
            scaspe_base = scaspe_new if symmetrize else None
            r = E.run_field_stage(
                grid, phys, sources,
                mode=M.MODE_DIRECT,
                u_fest=u_fest_iter,
                u_init=u,
                en_lim=en_lim,
                bm_par=bm_par_sca,
                bm_par_max=bm_par_max,
                wall_lo=wall_lo,
                wall_hi=wall_hi,
                chunk=chunk,
                scaspe_cfg=scfg,
                scaspe_init=scaspe_new,
                src_lum_fn=src_lum_fn,
                mesh=mesh,
            )
            u = r.u
            scaspe_new = r.scaspe
            if symmetrize:
                from . import symmetry as SYM

                # device-resident symmetrization (a per-pass numpy round
                # trip would move the whole field and scaspe)
                sdev = SYM.dev_ops(sym, perms)
                u = sdev.fix_u(u, jnp.asarray(u_base, dtype=fdtype))
                scaspe_new = sdev.fix_scaspe_delta(scaspe_new, scaspe_base)
                lum_lost += 8.0 * r.lum_lost
            else:
                lum_lost += r.lum_lost
            for k, v in r.stats.items():
                stats[f"scatt_{k}"] = stats.get(f"scatt_{k}", 0) + v

        scaspe_tot = ScaspeConfig.add(scaspe_tot, scaspe_new)
        scaspe_prev = scaspe_new

    return ScatteringResult(
        u_final=u,
        scaspe_tot=scaspe_tot,
        iterations=it,
        converged=converged,
        lum_lost=lum_lost,
        tot_rad_en=tot_rad_en,
        stats=stats,
    )
