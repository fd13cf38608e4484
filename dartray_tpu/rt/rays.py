"""Adaptive ray management: the HEALPix nside ladder.

Rebuild of main_dir_loop + ray_list (rt_routines.f90:1343-1467,
ray_list.f90): every source emits rays over the sphere starting at
nside_min=4; rays blocked for too-low angular density respawn as 4 children
at twice the nside from the blocking point; rays blocked for too-high
density merge 4->1 at half the nside when they share the parent pixel, the
blocking-plane axis and the plane distance within 0.1%
(extract_ray_list, ray_list.f90:210-296).

The reference runs one source per OpenMP task with thread-private dynamic
lists.  Here the ladder is *global and batched*: one march() call advances
every pending ray of every source at a given nside in lock-step on the
accelerator, and the (small) blocked-ray records are regrouped between
levels with numpy on the host.  Physics is order-independent (deposits
commute), so the batching changes nothing but the summation order.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List

import numpy as np
import jax
import jax.numpy as jnp


def _is_dev(a):
    return isinstance(a, jax.Array)


class _RowView:
    """Lazy row-subset view of a (n, L) device array already pulled to host
    for a known index set: v[idx] returns the host rows for idx (which must
    be a subset of the pulled set)."""

    def __init__(self, rows: np.ndarray, idx: np.ndarray, n: int):
        self._rows = rows
        self._lookup = np.full(n, -1, dtype=np.int64)
        self._lookup[idx] = np.arange(len(idx))

    def __getitem__(self, idx):
        pos = self._lookup[idx]
        assert pos.min(initial=0) >= 0, "row not in the pulled subset"
        return self._rows[pos]


def _take(a, idx):
    if _is_dev(a):
        return jnp.take(a, jnp.asarray(idx), axis=0)
    if isinstance(a, _RowView):
        return a[idx]
    return np.asarray(a)[idx]


def _repeat(a, k):
    return jnp.repeat(a, k, axis=0) if _is_dev(a) else np.repeat(a, k, axis=0)


def _concat(parts):
    return jnp.concatenate(parts) if any(_is_dev(x) for x in parts) else np.concatenate(parts)

from .. import healpix as hp
from .march import RayBatch, MarchResult, ST_ACTIVE, ST_HIGH, ST_LOW, ST_GONE, march

NSIDE_MIN = 4  # rt_routines.f90:60
NSIDE_MAX = 8192  # safety cap (the blocking window terminates well before)


@dataclasses.dataclass
class Blocked:
    """Host-side record arrays of blocked rays at one nside."""

    src_pos: np.ndarray  # (n,3)
    src_cell: np.ndarray  # (n,)
    src_idx: np.ndarray  # (n,) source index (for merge grouping / stats)
    ipix: np.ndarray  # (n,) pixel id at the record's nside
    theta: np.ndarray
    phi: np.ndarray
    lum: np.ndarray  # (n,L)
    prev: np.ndarray
    cc_old: np.ndarray
    isel_old: np.ndarray
    dplane: np.ndarray

    @property
    def n(self):
        return len(self.src_cell)

    @classmethod
    def empty(cls, L):
        z = np.zeros(0)
        zi = np.zeros(0, dtype=np.int64)
        return cls(np.zeros((0, 3)), zi, zi, zi, z, z, np.zeros((0, L)), z, zi, zi, z)

    @classmethod
    def concat(cls, items):
        items = [b for b in items if b.n > 0]
        if not items:
            return None
        return cls(
            **{
                f.name: _concat([getattr(b, f.name) for b in items])
                for f in dataclasses.fields(cls)
            }
        )


def fresh_launch(src_pos, src_cell, src_idx, lum, nside=NSIDE_MIN, pix_subset=None):
    """All-sky launch: one ray per HEALPix pixel at `nside` per source.

    Equivalent to the reference's 12 sectors x 4 subsectors x 4 pixels
    (create_high_ray_list ray_list.f90:71 + the first extract at nside=4).
    """
    npix = 12 * nside * nside if pix_subset is None else len(pix_subset)
    pix = np.arange(12 * nside * nside) if pix_subset is None else np.asarray(pix_subset)
    ns = len(src_cell)
    theta, phi = hp.np_pix2ang_nest(nside, pix)
    theta = np.asarray(theta)
    phi = np.asarray(phi)

    rep = lambda a: np.repeat(a, npix, axis=0)
    tile = lambda a: np.tile(a, ns)
    return dict(
        src_pos=rep(np.asarray(src_pos)),
        src_cell=rep(np.asarray(src_cell)),
        src_idx=rep(np.asarray(src_idx)),
        ipix=tile(pix),
        theta=tile(theta),
        phi=tile(phi),
        lum=_repeat(lum, npix),  # device lum stays on device
        prev=np.zeros(ns * npix),
        cc_old=rep(np.asarray(src_cell)),
        isel_old=np.full(ns * npix, -1, dtype=np.int64),
        dplane=np.zeros(ns * npix),
        fresh=np.ones(ns * npix, dtype=bool),
        seen_other=np.zeros(ns * npix, dtype=bool),
    )


def _to_batch(d, L, pad_to=None, fdtype=jnp.float64):
    """Host dict -> padded device RayBatch.

    All host-side per-ray scalars are packed into TWO matrices uploaded
    with one transfer each (every separate jnp.asarray is its own
    host->device transfer); only the (m, L) luminosity goes up on its own
    (it is often already device-resident from the previous round).
    """
    n = len(d["src_cell"])
    m = pad_to or n
    pad = m - n

    def p(a, fill=0):
        if _is_dev(a):
            if pad:
                w = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
                a = jnp.pad(a, w, constant_values=fill)
            return a
        a = np.asarray(a)
        if pad == 0:
            return a
        w = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, w, constant_values=fill)

    fm = np.zeros((7, m), dtype=np.dtype(fdtype))
    fm[0:3, :n] = np.asarray(d["src_pos"]).T
    fm[3, :n] = d["theta"]
    fm[4, :n] = d["phi"]
    fm[5, :n] = d["prev"]
    if "nside" in d:
        fm[6, :n] = 4.0 * np.pi / (
            12.0 * np.asarray(d["nside"], dtype=np.float64) ** 2
        )
    fm[6, n:] = 1.0
    im = np.zeros((5, m), dtype=np.int32)
    im[0, :n] = d["src_cell"]
    im[1, :n] = d["ipix"]
    im[2, :n] = d["isel_old"]
    im[3, :n] = (
        np.asarray(d["fresh"], dtype=np.int32)
        + 2 * np.asarray(d.get("seen_other", np.zeros(n, dtype=bool)),
                         dtype=np.int32)
    )
    if "nside" in d:
        # reco rays that already failed a merge pass must deposit rather
        # than re-block at the same plane forever (the reference ladder
        # bottoms out at nside <= 2*nside_min, deposit rt:2494)
        cm = np.asarray(d["nside"]) > 2 * NSIDE_MIN
        if "nomerge" in d:
            cm = cm & ~np.asarray(d["nomerge"], dtype=bool)
        im[3, :n] += 4 * cm
    im[4, :n] = 1  # active
    fm_d = jnp.asarray(fm)
    im_d = jnp.asarray(im)
    batch = RayBatch(
        src_pos=fm_d[0:3].T,
        src_cell=im_d[0],
        theta=fm_d[3],
        phi=fm_d[4],
        ipix=im_d[1],
        lum=jnp.asarray(p(d["lum"]), dtype=fdtype),
        prev=fm_d[5],
        cc_old=im_d[0],
        isel_old=im_d[2],
        fresh=(im_d[3] & 1) == 1,
        seen_other=(im_d[3] & 2) == 2,
        active=im_d[4] == 1,
    )
    beam_i = fm_d[6]
    can_merge = (im_d[3] & 4) == 4
    return batch, beam_i, can_merge


def _bucket(n, minimum=1024, factor=4):
    """Round up to minimum * factor^k, factor 2 above 64k (bounds the
    number of jit specializations: each distinct batch size costs a march
    compile, so coarse buckets trade padding for fewer compiles, and the
    factor drops to 2 where 4x padding would waste real iteration time)."""
    m = minimum
    while m < n:
        m *= factor if m < (1 << 16) else 2
    return m


def split_high(blocked: Blocked, nside: int):
    """4x refinement of blocked-high rays: children at 2*nside from the
    blocking point (main_dir_loop rt_routines.f90:1389-1396)."""
    n = blocked.n
    child_pix = (blocked.ipix[:, None] * 4 + np.arange(4)[None, :]).ravel()
    theta, phi = hp.np_pix2ang_nest(2 * nside, child_pix)
    rep = lambda a: np.repeat(a, 4, axis=0)
    return dict(
        src_pos=rep(blocked.src_pos),
        src_cell=rep(blocked.src_cell),
        src_idx=rep(blocked.src_idx),
        ipix=child_pix,
        theta=np.asarray(theta),
        phi=np.asarray(phi),
        lum=_repeat(blocked.lum, 4),
        prev=rep(blocked.prev),
        cc_old=rep(blocked.cc_old),
        isel_old=rep(blocked.isel_old),
        dplane=rep(blocked.dplane),
        fresh=np.zeros(4 * n, dtype=bool),
        seen_other=np.zeros(4 * n, dtype=bool),
    )


def merge_low(blocked: Blocked, nside: int):
    """Group blocked-low rays (at `nside`) into parents at nside/2.

    Merge requires 4 children with the same (source, parent pixel, blocking
    axis) and plane distances within 0.1% (extract_ray_list,
    ray_list.f90:245-269).  Returns (merged_dict_at_half_nside, reco_dict)
    where reco rays re-run individually at `nside`
    (ray_type_reco, ray_list.f90:276-291).
    """
    n = blocked.n
    parent = blocked.ipix // 4
    # group key
    key = (blocked.src_idx.astype(np.int64) * (12 * nside * nside // 4) + parent) * 4 + blocked.isel_old
    order = np.lexsort((blocked.dplane, key))
    k = key[order]
    # vectorized grouping: within each sorted key-run, consecutive 4-tuples
    # with matching dplane merge (the reference matches each leader with up
    # to 3 later entries, ray_list.f90:237-269; dplane-sorted quadruples are
    # equivalent up to ties)
    starts = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])
    run_id = np.cumsum(np.r_[True, k[1:] != k[:-1]]) - 1
    pos = np.arange(n) - starts[run_id]
    quad = pos // 4
    counts = np.diff(np.r_[starts, n])
    full_quad = (quad + 1) * 4 <= counts[run_id]  # quad fully inside the run
    # dplane tolerance vs the quad leader
    dpl = blocked.dplane[order]
    lead_idx = starts[run_id] + quad * 4
    lead = dpl[np.clip(lead_idx, 0, n - 1)]
    tol_ok = np.abs(dpl - lead) <= 0.001 * np.maximum(np.abs(lead), 1e-300)
    # a quad merges iff all four members are in tolerance
    qkey = run_id * (n + 1) + quad
    uq, inv = np.unique(qkey, return_inverse=True)
    ok_per_quad = np.zeros(len(uq), dtype=np.int64)
    np.add.at(ok_per_quad, inv, (tol_ok & full_quad).astype(np.int64))
    merge_mask = ok_per_quad[inv] == 4
    merged_idx = order[merge_mask]
    rr = order[~merge_mask]

    L = blocked.lum.shape[1]
    if merged_idx.size:
        mr = merged_idx.reshape(-1, 4)  # (m, 4)
        ppix = parent[mr[:, 0]]
        theta, phi = hp.np_pix2ang_nest(nside // 2, ppix)
        merged = dict(
            src_pos=blocked.src_pos[mr[:, 0]],
            src_cell=blocked.src_cell[mr[:, 0]],
            src_idx=blocked.src_idx[mr[:, 0]],
            ipix=ppix,
            theta=np.asarray(theta),
            phi=np.asarray(phi),
            lum=(jnp.take(blocked.lum, jnp.asarray(mr.ravel()), axis=0)
                 .reshape(len(mr), 4, L).mean(axis=1)
                 if _is_dev(blocked.lum) else blocked.lum[mr].mean(axis=1)),
            prev=blocked.prev[mr].mean(axis=1),
            cc_old=blocked.cc_old[mr[:, 0]],
            isel_old=blocked.isel_old[mr[:, 0]],
            dplane=blocked.dplane[mr[:, 0]],
            fresh=np.zeros(len(mr), dtype=bool),
            seen_other=np.zeros(len(mr), dtype=bool),
        )
    else:
        merged = None

    if rr.size:
        reco = dict(
            src_pos=blocked.src_pos[rr],
            src_cell=blocked.src_cell[rr],
            src_idx=blocked.src_idx[rr],
            ipix=blocked.ipix[rr],
            theta=blocked.theta[rr],
            phi=blocked.phi[rr],
            lum=_take(blocked.lum, rr),
            prev=blocked.prev[rr],
            cc_old=blocked.cc_old[rr],
            isel_old=blocked.isel_old[rr],
            dplane=blocked.dplane[rr],
            fresh=np.zeros(len(rr), dtype=bool),
            seen_other=np.zeros(len(rr), dtype=bool),
        )
    else:
        reco = None
    return merged, reco


def collect_rows(d: dict, res_h: MarchResult, sel) -> Blocked:
    """Extract the selected blocked rays into a host-side Blocked record
    (luminosity/prev taken at the blocking point).  `res_h` carries the
    outputs as ready numpy arrays (bulk device->host conversions, once
    per round)."""
    return Blocked(
        src_pos=np.asarray(d["src_pos"])[sel],
        src_cell=np.asarray(d["src_cell"])[sel],
        src_idx=np.asarray(d["src_idx"])[sel],
        ipix=np.asarray(d["ipix"])[sel],
        theta=np.asarray(d["theta"])[sel],
        phi=np.asarray(d["phi"])[sel],
        lum=_take(res_h.lum, sel),
        prev=np.asarray(res_h.prev)[sel],
        cc_old=np.asarray(res_h.cc)[sel],
        isel_old=np.asarray(res_h.isel_old)[sel],
        dplane=np.asarray(res_h.dplane)[sel],
    )


def collect_blocked(d: dict, res: MarchResult, status: int) -> Blocked:
    """collect_rows over all rays that finished with `status`."""
    st = np.asarray(res.status)
    nin = len(d["src_cell"])
    sel = np.flatnonzero(st[:nin] == status)
    if len(sel) == 0:
        return Blocked.empty(res.lum.shape[1])
    host = MarchResult(
        status=st, lum=res.lum, prev=np.asarray(res.prev),
        cc=np.asarray(res.cc), isel_old=np.asarray(res.isel_old),
        dplane=np.asarray(res.dplane), lum_lost=None, i_obs=None,
        n_steps=None,
    )
    return collect_rows(d, host, sel)


# ---------------------------------------------------------------------------
# global mixed-nside round driver
# ---------------------------------------------------------------------------
#
# The reference climbs/descends the nside ladder per source sector
# (define_next_level, rt_routines.f90:2745-2770), which on an accelerator
# fragments the work into many small latency-bound kernel launches.  Since
# deposits commute and the blocking rules depend only on the per-ray solid
# angle beam_i(nside), rays at *different* nside can march together in one
# batch: beam_i becomes a per-ray array.  The driver below keeps a work
# queue of ray packets (fresh launches, continuations, 4x splits, merges,
# recos), assembles up to `pool_max` rays per kernel call, and classifies
# the outcome back into the queue — a few large calls instead of hundreds
# of small ones.

# rays per assembled march call.  65536 was tuned on the previous
# accelerator; not yet tuned on the H100.
POOL_MAX = int(os.environ.get("DARTRAY_POOL_MAX", str(1 << 16)))
_POOL_FIELDS = (
    "src_pos", "src_cell", "src_idx", "ipix", "theta", "phi", "lum",
    "prev", "cc_old", "isel_old", "dplane", "fresh", "seen_other", "nside",
    "nomerge",
)


def _dict_rows(d, sel):
    """Row subset of a pool dict (device lum stays on device)."""
    return {k: _take(d[k], sel) for k in _POOL_FIELDS if k in d}


def _dict_slice(d, lo, hi):
    return {
        k: (d[k][lo:hi] if not _is_dev(d[k]) else
            jax.lax.slice_in_dim(d[k], lo, hi, axis=0))
        for k in _POOL_FIELDS if k in d
    }


def _dict_concat(parts):
    out = {}
    for k in _POOL_FIELDS:
        if k in parts[0]:
            out[k] = _concat([p[k] for p in parts])
    return out


def run_rounds(
    march_fn: Callable,
    launches,
    L: int,
    fdtype=jnp.float64,
    stats: dict | None = None,
    src_lum_fn: Callable | None = None,
    pool_max: int = POOL_MAX,
    host_lum: bool = False,
):
    """Drive every ray of every source to completion in global rounds.

    march_fn(batch: RayBatch, beam_i (m,), can_merge (m,), d: dict,
    max_steps) -> MarchResult — closure over grid/physics/accumulators.
    `launches` is an iterable of fresh-launch dicts (see fresh_launch),
    consumed lazily so the queue never materializes more than ~pool_max
    rays of fresh sources at a time.  src_lum_fn(d, nside_arr) -> (n, L)
    overrides the launch luminosity of fresh rays (scattering stage).
    """
    if stats is None:
        stats = {}
    gen = iter(launches)
    queue: List[dict] = []
    n_queued = 0

    def push(d):
        nonlocal n_queued
        n = len(d["src_cell"])
        if n:
            if "nomerge" not in d:
                d = dict(d, nomerge=np.zeros(n, dtype=bool))
            queue.append(d)
            n_queued += n

    def assemble():
        """Pop up to pool_max rays from the queue (+ fresh launches)."""
        nonlocal n_queued
        take: List[dict] = []
        room = pool_max
        while room > 0:
            if not queue:
                nxt = next(gen, None)
                if nxt is None:
                    break
                if "nside" not in nxt:
                    nxt = dict(nxt, nside=np.full(
                        len(nxt["src_cell"]), NSIDE_MIN, dtype=np.int64))
                push(nxt)
                continue
            d = queue.pop()
            n = len(d["src_cell"])
            n_queued -= n
            if n <= room:
                take.append(d)
                room -= n
            else:
                take.append(_dict_slice(d, 0, room))
                push(_dict_slice(d, room, n))
                room = 0
        if not take:
            return None
        return take[0] if len(take) == 1 else _dict_concat(take)

    import os, time
    _dbg = os.environ.get("DARTRAY_DEBUG_ROUNDS")
    while True:
        t_a0 = time.perf_counter() if _dbg else 0.0
        d = assemble()
        if d is None:
            break
        n = len(d["src_cell"])
        nside = np.asarray(d["nside"])
        t_a1 = time.perf_counter() if _dbg else 0.0
        if src_lum_fn is not None and np.any(d["fresh"]):
            lum = src_lum_fn(d, nside)
            d = dict(d)
            if _is_dev(d["lum"]) or _is_dev(lum):
                d["lum"] = jnp.where(
                    jnp.asarray(d["fresh"])[:, None], jnp.asarray(lum),
                    jnp.asarray(d["lum"]))
            else:
                d["lum"] = np.where(d["fresh"][:, None], lum, d["lum"])
        t_a2 = time.perf_counter() if _dbg else 0.0
        m = _bucket(n)
        batch, beam_i, can_merge = _to_batch(d, L, pad_to=m, fdtype=fdtype)
        if _dbg:
            print(f"# prep  assemble={t_a1-t_a0:.4f}s srclum={t_a2-t_a1:.4f}s "
                  f"tobatch={time.perf_counter()-t_a2:.4f}s", flush=True)
        t0 = time.perf_counter() if _dbg else 0.0
        # below a quarter pool there is little to compact: let the kernel
        # run longer between host round trips — the while cond
        # exits as soon as every ray finishes, so long chunks cost nothing
        small = n <= pool_max // 4
        res = march_fn(batch, beam_i, can_merge, d, small=small)
        # one bulk device->host transfer per round; all row selection below
        # happens in numpy
        if res.packed_all is not None:
            pa = np.asarray(res.packed_all)
            pi = pa[:8]
            pf = pa[8:].view(np.float32)
        else:
            pi = np.asarray(res.packed_i)
            pf = np.asarray(res.packed_f)
        stats["rays"] = stats.get("rays", 0) + n
        steps_now = int(pi[6, 0])
        stats["steps"] = stats.get("steps", 0) + steps_now
        iters_now = int(pi[7, 0]) if pi.shape[0] > 7 else 0
        stats["iters"] = stats.get("iters", 0) + iters_now
        L_lost = stats.get("lum_lost")
        Lw = res.lum.shape[1]
        stats["lum_lost"] = (pf[2, :Lw] if L_lost is None
                             else L_lost + pf[2, :Lw])
        stats["lum_esc"] = stats.get("lum_esc", 0.0) + pf[3, :Lw]
        st = pi[0, :n]
        if not host_lum:
            # scaspe-less stages: luminosities stay device-resident and
            # every regroup is a lazy device op (no sync)
            lum_h = res.lum
        else:
            # scattering stages regroup tens of thousands of blocked rays
            # per round: ONE bulk lum transfer covering exactly the rays
            # the host needs (continuations + blocked) replaces 10-30
            # per-group device round trips
            need = np.flatnonzero(st != ST_GONE)
            if len(need) > int(0.7 * n):
                lum_h = np.asarray(res.lum)[:n]
            elif len(need) == 0:
                lum_h = _RowView(np.zeros((0, Lw)), need, n)
            else:
                # pad the gather indices to bucketed sizes: a distinct
                # index count per round would force a compile per round
                mb = _bucket(len(need), minimum=256)
                need_p = np.zeros(mb, dtype=np.int64)
                need_p[: len(need)] = need
                rows = np.asarray(
                    jnp.take(res.lum, jnp.asarray(need_p), axis=0)
                )[: len(need)]
                lum_h = _RowView(rows, need, n)
        res_h = MarchResult(
            status=st,
            lum=lum_h,
            prev=pf[0],
            cc=pi[1],
            isel_old=pi[2],
            dplane=pf[1],
            lum_lost=None,
            i_obs=None,
            n_steps=steps_now,
            cc_cur=pi[3],
            isel_cur=pi[4],
            seen_other=pi[5].astype(bool),
        )
        if _dbg:
            t1 = time.perf_counter()
            print(f"# round n={n} pad={m} steps={steps_now} "
                  f"iters={iters_now} t={t1-t0:.4f}s "
                  f"({(t1-t0)/max(iters_now,1)*1e3:.2f} ms/iter) "
                  f"queued={n_queued}", flush=True)
        t_post0 = time.perf_counter() if _dbg else 0.0

        # continuations: rays still in flight after the step chunk
        act = np.flatnonzero(st == ST_ACTIVE)
        stats["rays"] -= len(act)  # resumed rays are not new rays
        if len(act):
            push(dict(
                src_pos=np.asarray(d["src_pos"])[act],
                src_cell=np.asarray(d["src_cell"])[act],
                src_idx=np.asarray(d["src_idx"])[act],
                ipix=np.asarray(d["ipix"])[act],
                theta=np.asarray(d["theta"])[act],
                phi=np.asarray(d["phi"])[act],
                lum=_take(lum_h, act),
                prev=res_h.prev[act],
                cc_old=res_h.cc_cur[act],
                isel_old=res_h.isel_cur[act],
                dplane=np.zeros(len(act)),
                fresh=np.zeros(len(act), dtype=bool),
                seen_other=res_h.seen_other[act],
                nside=nside[act],
                nomerge=np.asarray(
                    d.get("nomerge", np.zeros(n, dtype=bool)))[act],
            ))

        # blocked-high: 4x angular refinement per nside group
        hi_mask = st == ST_HIGH
        if hi_mask.any():
            for ns in np.unique(nside[hi_mask]):
                if 2 * ns > NSIDE_MAX:
                    raise RuntimeError("nside ladder exceeded NSIDE_MAX")
                sel = np.flatnonzero(hi_mask & (nside == ns))
                blk = collect_rows(d, res_h, sel)
                push(dict(split_high(blk, int(ns)),
                          nside=np.full(4 * len(sel), 2 * ns, dtype=np.int64)))

        # blocked-low: merge 4->1 per nside group; unmatched rays re-run
        lo_mask = st == ST_LOW
        if lo_mask.any():
            for ns in np.unique(nside[lo_mask]):
                sel = np.flatnonzero(lo_mask & (nside == ns))
                blk = collect_rows(d, res_h, sel)
                merged, reco = merge_low(blk, int(ns))
                if merged is not None:
                    push(dict(merged, nside=np.full(
                        len(merged["src_cell"]), ns // 2, dtype=np.int64)))
                if reco is not None:
                    nrr = len(reco["src_cell"])
                    push(dict(reco, nside=np.full(nrr, ns, dtype=np.int64),
                              nomerge=np.ones(nrr, dtype=bool)))
        if _dbg:
            print(f"# post  {time.perf_counter()-t_post0:.4f}s "
                  f"act={len(act)} hi={int(hi_mask.sum())} "
                  f"lo={int(lo_mask.sum())}", flush=True)
    return stats
