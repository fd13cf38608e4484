"""Vectorized HEALPix NESTED-scheme pixelization in JAX.

Reimplementation of the functionality in the reference's
``healpix_routines.f90`` (pix2ang_nest at healpix_routines.f90:30,
ang2pix_nest at :238, neighbours_nest at :416, nside2npix at :180).

Unlike the reference (scalar Fortran with lookup tables built at runtime),
everything here is branch-free vectorized integer arithmetic that works on
arrays of pixels under ``jit``/``vmap``.  Angle convention matches HEALPix:
theta is the colatitude measured from +Z, phi the azimuth from +X in [0, 2pi).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = [
    "nside2npix",
    "pix2ang_nest",
    "ang2pix_nest",
    "pix2vec_nest",
    "vec2pix_nest",
    "ang2vec",
    "neighbours_nest",
]

# face data, from the HEALPix specification (jrll/jpll as in
# healpix_routines.f90:44-45)
_JRLL = np.array([2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4], dtype=np.int64)
_JPLL = np.array([1, 3, 5, 7, 0, 2, 4, 6, 1, 3, 5, 7], dtype=np.int64)


def nside2npix(nside: int) -> int:
    return 12 * nside * nside


def _int_dtype():
    """int64 when x64 is enabled, else int32 (JAX's default).

    In 32-bit mode pixel ids fit int32 up to nside=8192 (npix = 8.05e8) and
    face coordinates use at most 13 bits, so the interleave below stays within
    26 bits.
    """
    import jax

    return jnp.int64 if jax.config.jax_enable_x64 else jnp.int32


def _float_dtype():
    import jax

    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def _mask(c):
    dt = _int_dtype()
    if dt == jnp.int32:
        c &= 0x7FFFFFFF
    return dt(c)


def _spread_bits(x):
    """Interleave zeros between the bits of x (up to 16 significant bits)."""
    dt = _int_dtype()
    x = jnp.asarray(x, dt)
    if dt == jnp.int64:
        x = (x | (x << 16)) & _mask(0x0000FFFF0000FFFF)
    x = (x | (x << 8)) & _mask(0x00FF00FF00FF00FF)
    x = (x | (x << 4)) & _mask(0x0F0F0F0F0F0F0F0F)
    x = (x | (x << 2)) & _mask(0x3333333333333333)
    x = (x | (x << 1)) & _mask(0x5555555555555555)
    return x


def _compress_bits(x):
    """Inverse of _spread_bits: keep even-position bits of x and pack them."""
    dt = _int_dtype()
    x = jnp.asarray(x, dt) & _mask(0x5555555555555555)
    x = (x | (x >> 1)) & _mask(0x3333333333333333)
    x = (x | (x >> 2)) & _mask(0x0F0F0F0F0F0F0F0F)
    x = (x | (x >> 4)) & _mask(0x00FF00FF00FF00FF)
    x = (x | (x >> 8)) & _mask(0x0000FFFF0000FFFF)
    if dt == jnp.int64:
        x = (x | (x >> 16)) & _mask(0x00000000FFFFFFFF)
    return x


def _xyf2pix(ix, iy, face, nside):
    return face * (nside * nside) + _spread_bits(ix) + (_spread_bits(iy) << 1)


def _pix2xyf(ipix, nside):
    ipix = jnp.asarray(ipix, _int_dtype())
    npface = nside * nside
    face = ipix // npface
    ipf = ipix - face * npface
    ix = _compress_bits(ipf)
    iy = _compress_bits(ipf >> 1)
    return ix, iy, face


def _pix2ang_nest_impl(nside: int, ipix):
    """theta, phi of the pixel centers (NESTED).  Vectorized over ipix.

    Mirrors healpix_routines.f90:30-136.
    """
    ipix = jnp.asarray(ipix, _int_dtype())
    ix, iy, face = _pix2xyf(ipix, nside)
    jrll = jnp.asarray(_JRLL)
    jpll = jnp.asarray(_JPLL)

    jrt = ix + iy  # 'vertical' in [0, 2(nside-1)]
    jpt = ix - iy  # 'horizontal' in [-nside+1, nside-1]
    jr = jrll[face] * nside - jrt - 1  # ring number in [1, 4 nside - 1]

    nl4 = 4 * nside
    fact1 = 1.0 / (3.0 * nside * nside)
    fact2 = 2.0 / (3.0 * nside)

    north = jr < nside
    south = jr > 3 * nside
    equat = ~(north | south)

    nr = jnp.where(north, jr, jnp.where(south, nl4 - jr, nside))
    z = jnp.where(
        north,
        1.0 - nr.astype(_float_dtype()) ** 2 * fact1,
        jnp.where(
            south,
            -1.0 + nr.astype(_float_dtype()) ** 2 * fact1,
            (2 * nside - jr).astype(_float_dtype()) * fact2,
        ),
    )
    kshift = jnp.where(equat, (jr - nside) & 1, 0)

    jp = (jpll[face] * nr + jpt + 1 + kshift) // 2
    jp = jnp.where(jp > nl4, jp - nl4, jp)
    jp = jnp.where(jp < 1, jp + nl4, jp)

    theta = jnp.arccos(jnp.clip(z, -1.0, 1.0))
    phi = (jp.astype(_float_dtype()) - (kshift.astype(_float_dtype()) + 1.0) * 0.5) * (
        jnp.pi / 2.0 / nr.astype(_float_dtype())
    )
    return theta, phi


def _ang2pix_nest_impl(nside: int, theta, phi):
    """NESTED pixel containing direction (theta, phi).  Vectorized.

    Mirrors healpix_routines.f90:238 onwards (standard HEALPix algorithm).
    """
    theta = jnp.asarray(theta)
    phi = jnp.asarray(phi)
    z = jnp.cos(theta)
    za = jnp.abs(z)
    tt = jnp.mod(phi, 2.0 * jnp.pi) * (2.0 / jnp.pi)  # in [0,4)

    # --- equatorial region ---
    temp1 = nside * (0.5 + tt)
    temp2 = nside * (z * 0.75)
    jp = jnp.floor(temp1 - temp2).astype(_int_dtype())  # ascending edge line index
    jm = jnp.floor(temp1 + temp2).astype(_int_dtype())  # descending edge line index
    ifp = jp // nside
    ifm = jm // nside
    face_eq = jnp.where(
        ifp == ifm,
        (ifp & 3) + 4,
        jnp.where(ifp < ifm, ifp & 3, (ifm & 3) + 8),
    )
    ix_eq = jm & (nside - 1)
    iy_eq = (nside - 1) - (jp & (nside - 1))

    # --- polar region ---
    ntt = jnp.clip(jnp.floor(tt).astype(_int_dtype()), 0, 3)
    tp = tt - ntt.astype(_float_dtype())
    tmp = nside * jnp.sqrt(3.0 * (1.0 - za))
    jp_p = jnp.floor(tp * tmp).astype(_int_dtype())
    jm_p = jnp.floor((1.0 - tp) * tmp).astype(_int_dtype())
    jp_p = jnp.minimum(jp_p, nside - 1)
    jm_p = jnp.minimum(jm_p, nside - 1)
    north = z >= 0
    face_po = jnp.where(north, ntt, ntt + 8)
    ix_po = jnp.where(north, nside - jm_p - 1, jp_p)
    iy_po = jnp.where(north, nside - jp_p - 1, jm_p)

    eq = za <= 2.0 / 3.0
    face = jnp.where(eq, face_eq, face_po)
    ix = jnp.where(eq, ix_eq, ix_po)
    iy = jnp.where(eq, iy_eq, iy_po)
    return _xyf2pix(ix, iy, face, nside)


def ang2vec(theta, phi):
    st = jnp.sin(theta)
    return jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), jnp.cos(theta)], axis=-1)


def _pix2vec_nest_impl(nside: int, ipix):
    theta, phi = _pix2ang_nest_impl(nside, ipix)
    return ang2vec(theta, phi)


def _vec2pix_nest_impl(nside: int, vec):
    vec = jnp.asarray(vec)
    r = jnp.sqrt(jnp.sum(vec**2, axis=-1))
    theta = jnp.arccos(jnp.clip(vec[..., 2] / r, -1.0, 1.0))
    phi = jnp.arctan2(vec[..., 1], vec[..., 0])
    return _ang2pix_nest_impl(nside, theta, phi)


# public jitted entry points (nside static => one compile per resolution)
import jax as _jax

pix2ang_nest = _jax.jit(_pix2ang_nest_impl, static_argnums=0)
ang2pix_nest = _jax.jit(_ang2pix_nest_impl, static_argnums=0)
pix2vec_nest = _jax.jit(_pix2vec_nest_impl, static_argnums=0)
vec2pix_nest = _jax.jit(_vec2pix_nest_impl, static_argnums=0)


# ---------------------------------------------------------------------------
# numpy mirrors — for the HOST side of the ray management (split/merge
# bookkeeping runs in numpy between march rounds; calling the jitted
# versions there would trigger a fresh device compile for every new ray
# count)
# ---------------------------------------------------------------------------


def _np_spread_bits(x):
    x = np.asarray(x, np.int64)
    x = (x | (x << 16)) & 0x0000FFFF0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F0F0F0F0F
    x = (x | (x << 2)) & 0x3333333333333333
    x = (x | (x << 1)) & 0x5555555555555555
    return x


def _np_compress_bits(x):
    x = np.asarray(x, np.int64) & 0x5555555555555555
    x = (x | (x >> 1)) & 0x3333333333333333
    x = (x | (x >> 2)) & 0x0F0F0F0F0F0F0F0F
    x = (x | (x >> 4)) & 0x00FF00FF00FF00FF
    x = (x | (x >> 8)) & 0x0000FFFF0000FFFF
    x = (x | (x >> 16)) & 0x00000000FFFFFFFF
    return x


def np_pix2ang_nest(nside: int, ipix):
    """numpy mirror of pix2ang_nest (float64)."""
    ipix = np.asarray(ipix, np.int64)
    npface = nside * nside
    face = ipix // npface
    ipf = ipix - face * npface
    ix = _np_compress_bits(ipf)
    iy = _np_compress_bits(ipf >> 1)
    jrt = ix + iy
    jpt = ix - iy
    jr = _JRLL[face] * nside - jrt - 1
    nl4 = 4 * nside
    fact1 = 1.0 / (3.0 * nside * nside)
    fact2 = 2.0 / (3.0 * nside)
    north = jr < nside
    south = jr > 3 * nside
    equat = ~(north | south)
    nr = np.where(north, jr, np.where(south, nl4 - jr, nside))
    z = np.where(
        north,
        1.0 - nr.astype(np.float64) ** 2 * fact1,
        np.where(
            south,
            -1.0 + nr.astype(np.float64) ** 2 * fact1,
            (2 * nside - jr).astype(np.float64) * fact2,
        ),
    )
    kshift = np.where(equat, (jr - nside) & 1, 0)
    jp = (_JPLL[face] * nr + jpt + 1 + kshift) // 2
    jp = np.where(jp > nl4, jp - nl4, jp)
    jp = np.where(jp < 1, jp + nl4, jp)
    theta = np.arccos(np.clip(z, -1.0, 1.0))
    phi = (jp.astype(np.float64) - (kshift + 1.0) * 0.5) * (
        np.pi / 2.0 / nr.astype(np.float64)
    )
    return theta, phi


def np_ang2pix_nest(nside: int, theta, phi):
    """numpy mirror of ang2pix_nest."""
    theta = np.asarray(theta, np.float64)
    phi = np.asarray(phi, np.float64)
    z = np.cos(theta)
    za = np.abs(z)
    tt = np.mod(phi, 2.0 * np.pi) * (2.0 / np.pi)
    temp1 = nside * (0.5 + tt)
    temp2 = nside * (z * 0.75)
    jp = np.floor(temp1 - temp2).astype(np.int64)
    jm = np.floor(temp1 + temp2).astype(np.int64)
    ifp = jp // nside
    ifm = jm // nside
    face_eq = np.where(
        ifp == ifm, (ifp & 3) + 4, np.where(ifp < ifm, ifp & 3, (ifm & 3) + 8)
    )
    ix_eq = jm & (nside - 1)
    iy_eq = (nside - 1) - (jp & (nside - 1))
    ntt = np.clip(np.floor(tt).astype(np.int64), 0, 3)
    tp = tt - ntt
    tmp = nside * np.sqrt(3.0 * (1.0 - za))
    jp_p = np.minimum(np.floor(tp * tmp).astype(np.int64), nside - 1)
    jm_p = np.minimum(np.floor((1.0 - tp) * tmp).astype(np.int64), nside - 1)
    north = z >= 0
    face_po = np.where(north, ntt, ntt + 8)
    ix_po = np.where(north, nside - jm_p - 1, jp_p)
    iy_po = np.where(north, nside - jp_p - 1, jm_p)
    eq = za <= 2.0 / 3.0
    face = np.where(eq, face_eq, face_po)
    ix = np.where(eq, ix_eq, ix_po)
    iy = np.where(eq, iy_eq, iy_po)
    return face * (nside * nside) + _np_spread_bits(ix) + (
        _np_spread_bits(iy) << 1
    )


# ---------------------------------------------------------------------------
# neighbours (NESTED scheme)
# ---------------------------------------------------------------------------


def _neighbours_nest_impl(nside: int, ipix):
    """See neighbours_nest."""
    ipix = jnp.atleast_1d(jnp.asarray(ipix, _int_dtype()))
    # Work at a finer resolution: descendants of each pixel two levels down.
    # Boundary descendants sit within 1/8 pixel of the true boundary; probing
    # a ~fine-pixel-sized step outward from them lands exactly in the coarse
    # neighbours without ever skipping a pixel (fine pixels are mildly
    # distorted at worst).
    F = 8  # refinement factor (3 levels)
    nf = F * nside
    lf2 = 2 * 3  # log2(F**2)

    # boundary descendants: fine (x,y) offsets on the rim of the F x F block
    rim = []
    for a in range(F):
        rim += [(a, 0), (a, F - 1), (0, a), (F - 1, a)]
    rim = sorted(set(rim))
    rim = np.array(rim, dtype=np.int64)  # (nrim, 2)
    sub = _spread_bits(jnp.asarray(rim[:, 0])) + (_spread_bits(jnp.asarray(rim[:, 1])) << 1)

    fine = (ipix[..., None] << lf2) + sub  # (..., nrim)
    theta, phi = pix2ang_nest(nf, fine)
    v = ang2vec(theta, phi)  # (..., nrim, 3)

    # local frame at each fine center
    zax = jnp.asarray([0.0, 0.0, 1.0])
    e1 = jnp.cross(jnp.broadcast_to(zax, v.shape), v)
    n1 = jnp.sqrt(jnp.sum(e1**2, axis=-1, keepdims=True))
    e1 = jnp.where(n1 > 1e-12, e1 / jnp.maximum(n1, 1e-300), jnp.asarray([1.0, 0.0, 0.0]))
    e2 = jnp.cross(v, e1)

    ang_f = np.sqrt(4.0 * np.pi / nside2npix(nf))
    alphas = np.linspace(0.0, 2 * np.pi, 16, endpoint=False)
    radii = np.array([0.9, 1.5, 2.0]) * ang_f
    ca = np.cos(alphas)[None, :]  # (1, 16)
    sa = np.sin(alphas)[None, :]
    rr = radii[:, None]  # (3, 1)
    dx = jnp.asarray((rr * ca).ravel())[:, None]  # (48, 1)
    dy = jnp.asarray((rr * sa).ravel())[:, None]
    # (..., nrim, 48, 3): all probes in one batched vec2pix call
    d = v[..., None, :] + dx * e1[..., None, :] + dy * e2[..., None, :]
    cand = _vec2pix_nest_impl(nf, d) >> lf2  # (..., nrim, 48) coarse pixel ids
    cand = cand.reshape(cand.shape[:-2] + (-1,))  # (..., nrim*48)

    # keep the distinct neighbours (up to 8), mask self/duplicates to -1,
    # and compact into a fixed (..., 8) slot array.
    cand = jnp.where(cand == ipix[..., None], -1, cand)
    cand = jnp.sort(cand, axis=-1)
    is_new = cand != jnp.concatenate(
        [jnp.full(cand.shape[:-1] + (1,), -2, cand.dtype), cand[..., :-1]], axis=-1
    )
    is_new = is_new & (cand >= 0)
    slot = jnp.cumsum(is_new, axis=-1) - 1  # target slot for each new value
    out = jnp.full(cand.shape[:-1] + (8,), -1, dtype=cand.dtype)
    flat_out = out.reshape(-1, 8)
    flat_cand = cand.reshape(-1, cand.shape[-1])
    flat_slot = jnp.where(is_new, slot, 8).reshape(-1, cand.shape[-1])
    rows = jnp.arange(flat_out.shape[0])[:, None]
    flat_out = jnp.pad(flat_out, ((0, 0), (0, 1)), constant_values=-1)
    flat_out = flat_out.at[rows, flat_slot].set(flat_cand)[:, :8]
    return flat_out.reshape(cand.shape[:-1] + (8,))


_neighbours_impl_jit = _jax.jit(_neighbours_nest_impl, static_argnums=0)


def neighbours_nest(nside: int, ipix):
    """Adjacent NESTED pixels of each pixel (vectorized).

    Replacement for healpix_routines.f90:416 ``neighbours_nest``:
    instead of face-adjacency tables it probes outward from fine-level
    descendant pixels on the pixel rim, which is exact for adjacency.  Returns
    shape ipix.shape + (8,), entries -1 where a pixel has only 7 neighbours
    (the 24 corner pixels touching polar face corners).
    """
    return _neighbours_impl_jit(nside, ipix)
