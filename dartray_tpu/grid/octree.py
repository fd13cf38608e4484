"""Adaptive octree grid: flat structure-of-arrays + vectorized navigation.

Rebuild of the reference's grid core (smooth_grid_routines.f90):

* the cell tables follow the reference layout exactly (cells stored flat,
  ``cchild[i]`` = id of the first child or -1 for leaves, children
  contiguous; two-level subdivision base ``(base1, base2)`` with the root
  split ``base1^3``-fold and every later split ``base2^3``-fold —
  smooth_grid_routines.f90:40-64,570-603), so reference-produced HDF5 grids
  load directly;

* navigation, however, replaces the int64 ``cindex`` bitcode walking
  (cindex_to_ccindd / ccindd_to_cc, smooth_grid_routines.f90:793-852) with
  *fine integer coordinates*: a cell at level l occupies an axis-aligned
  block of side ``2^(max_lvl-l)`` on the virtual finest grid of
  ``base1 * base2^(max_lvl-1)`` cells per axis.  A position maps to fine
  coordinates with one floor per level, and tree descent is a fixed-trip
  gather loop — both fully vectorized and jit/vmap-friendly (no per-ray
  recursion, no dynamic shapes).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Grid:
    """Flat octree grid (pytree of arrays + static metadata).

    Mirrors the reference's main-grid arrays (smooth_grid_routines.f90:40-64
    and the HDF5 schema of io_routines.f90:185-199).
    """

    cchild: jax.Array  # (N,) int32, first-child id or -1
    lvl: jax.Array  # (N,) int32, subdivision level (root = 0)
    ccoord: jax.Array  # (N,3) float, cell centers (model units, origin center)
    csize: jax.Array  # (N,) float, cell side length
    dens_ref: jax.Array  # (N,) float, extinction coeff at lambda_ref [1/length]
    dens_stars_ref: jax.Array  # (N,) float, source emissivity [lum/volume]
    # static metadata (hashable, not traced)
    base: tuple = dataclasses.field(metadata=dict(static=True))
    max_lvl: int = dataclasses.field(metadata=dict(static=True))
    modelsize: float = dataclasses.field(metadata=dict(static=True))

    @property
    def n_cells(self) -> int:
        return self.cchild.shape[0]

    @property
    def n_fine(self) -> int:
        """Cells per axis of the virtual finest grid."""
        return self.base[0] * self.base[1] ** (self.max_lvl - 1)

    def csize_levels(self) -> np.ndarray:
        """Cell size per level, index 0..max_lvl (csize_arr in the reference,
        calc_cellsize smooth_grid_routines.f90:608-619)."""
        out = np.empty(self.max_lvl + 1)
        out[0] = self.modelsize
        for l in range(1, self.max_lvl + 1):
            out[l] = self.modelsize / (self.base[0] * self.base[1] ** (l - 1))
        return out

    def fine_per_level(self) -> np.ndarray:
        """Side length, in fine cells, of a cell at each level."""
        out = np.empty(self.max_lvl + 1, dtype=np.int32)
        out[0] = self.n_fine
        for l in range(1, self.max_lvl + 1):
            out[l] = self.base[1] ** (self.max_lvl - l)
        return out

    def leaf_mask(self):
        return self.cchild == -1


# ---------------------------------------------------------------------------
# coordinate <-> fine integer coordinates
# ---------------------------------------------------------------------------


def pos_to_fine(grid: Grid, pos):
    """Position (..., 3) -> fine integer coordinates (..., 3) int32.

    Matches the per-level floor-and-clamp of find_cc_new2
    (rt_routines.f90:2005-2025): each level's digit is clamped to the valid
    range so positions that land exactly on a cell edge (within roundoff)
    resolve to the lower cell, exactly as in the reference.
    """
    csizes = grid.csize_levels()
    b1, b2 = grid.base
    norm = jnp.asarray(pos) + grid.modelsize / 2.0
    fine = jnp.zeros(jnp.shape(pos), dtype=jnp.int32)
    spl = grid.fine_per_level()
    for l in range(1, grid.max_lvl + 1):
        b = b1 if l == 1 else b2
        digit = jnp.floor(norm / csizes[l]).astype(jnp.int32)
        digit = jnp.clip(digit, 0, b - 1)
        norm = norm - digit * csizes[l]
        fine = fine + digit * int(spl[l])
    return fine


def fine_to_digits(grid: Grid, fine, level: int):
    """Digit (child index within parent) of the fine coords at `level`."""
    spl = grid.fine_per_level()
    if level == 1:
        return fine // int(spl[1])
    return (fine // int(spl[level])) % grid.base[1]


@jax.jit
def fine_to_cell(grid: Grid, fine):
    """Fine integer coords (..., 3) -> (cell id, level) of the containing leaf.

    Vectorized replacement for ccindd_to_cc (smooth_grid_routines.f90:820-852):
    descend the tree one level at a time with gathers; stop at leaves via
    masking (fixed trip count = max_lvl).
    """
    fine = jnp.asarray(fine)
    b1, b2 = grid.base
    spl = grid.fine_per_level()

    batch_shape = fine.shape[:-1]
    child_base = jnp.broadcast_to(grid.cchild[0].astype(jnp.int32), batch_shape)
    cell = jnp.zeros(batch_shape, dtype=jnp.int32)
    clvl = jnp.zeros(batch_shape, dtype=jnp.int32)
    done = jnp.zeros(batch_shape, dtype=bool)

    for l in range(1, grid.max_lvl + 1):
        b = b1 if l == 1 else b2
        if l == 1:
            d = fine // int(spl[1])
        else:
            d = (fine // int(spl[l])) % b2
        k = (d[..., 2] * b + d[..., 1]) * b + d[..., 0]
        new_cell = child_base + k
        cell = jnp.where(done, cell, new_cell)
        clvl = jnp.where(done, clvl, l)
        cb = grid.cchild[jnp.clip(new_cell, 0, grid.n_cells - 1)]
        is_leaf = cb == -1
        done = done | (~done & is_leaf)
        child_base = jnp.where(done, child_base, cb)
    return cell, clvl


def point_to_cell(grid: Grid, pos):
    """Position -> (leaf cell id, level)."""
    return fine_to_cell(grid, pos_to_fine(grid, pos))


# ---------------------------------------------------------------------------
# face-neighbour navigation table
# ---------------------------------------------------------------------------
#
# The octree descent of the march hot loop (up to max_lvl dependent
# 1-wide gathers per ray per step) is replaced by ONE 8-wide row gather
# from this precomputed table.  The reference's equivalent is the neighbour bookkeeping of
# find_neighbours + ccindd_to_cc (smooth_grid_routines.f90:656-748,820-852);
# here it is precomputed once per grid because the grid is static during RT.

NAV_W = 8  # row: [nbr, child_base, nbr_lvl, fx0, fy0, fz0, pad, pad]


def cell_fine_origin(grid: Grid) -> np.ndarray:
    """(N, 3) int32 fine-coordinate origin (lowest corner) of every cell."""
    fine_size = grid.modelsize / grid.n_fine
    corner = (
        np.asarray(grid.ccoord, dtype=np.float64)
        - np.asarray(grid.csize, dtype=np.float64)[:, None] / 2.0
        + grid.modelsize / 2.0
    )
    return np.rint(corner / fine_size).astype(np.int32)


def build_nav_table(grid: Grid, validate: bool = True) -> np.ndarray:
    """(N*6, NAV_W) int32 navigation table.

    Row ``cell*6 + face`` with ``face = axis*2 + (1 if leaving through the
    +axis wall else 0)`` holds, for the region adjacent to that wall:

      [nbr, child_base, nbr_lvl, fx0, fy0, fz0, 0, 0]

    where ``nbr`` is the deepest tree node at depth <= lvl(cell) containing
    the region (-1 outside the grid), ``child_base = cchild[nbr]`` (-1 when
    nbr is a leaf), ``nbr_lvl`` its level and ``f*0`` its fine-coordinate
    origin.  Because neighbouring leaves differ by at most one level (the
    grid grading enforced at construction, check_level_jump
    smooth_grid_routines.f90:774-791), a single conditional descent from
    ``nbr`` resolves the leaf the ray enters.
    """
    cchild = np.asarray(grid.cchild, dtype=np.int64)
    lvl = np.asarray(grid.lvl, dtype=np.int64)
    n = len(cchild)
    b1, b2 = grid.base
    spl = grid.fine_per_level().astype(np.int64)
    n_fine = grid.n_fine
    f0 = cell_fine_origin(grid).astype(np.int64)  # (N,3)
    span = spl[lvl]  # (N,)

    # face-adjacent query point (one fine cell beyond the wall)
    q = np.repeat(f0[:, None, :], 6, axis=1)  # (N, 6, 3)
    for ax in range(3):
        q[:, ax * 2 + 0, ax] = f0[:, ax] - 1
        q[:, ax * 2 + 1, ax] = f0[:, ax] + span
    q = q.reshape(n * 6, 3)
    lvl_q = np.repeat(lvl, 6)
    outside = np.any((q < 0) | (q >= n_fine), axis=1)

    # vectorized walk to depth lvl_q (or the first leaf above it)
    node = np.zeros(n * 6, dtype=np.int64)
    nlvl = np.zeros(n * 6, dtype=np.int64)
    origin = np.zeros((n * 6, 3), dtype=np.int64)
    child_base = np.full(n * 6, cchild[0], dtype=np.int64)
    done = outside.copy()
    for l in range(1, grid.max_lvl + 1):
        if l == 1:
            d = q // spl[1]
        else:
            d = (q // spl[l]) % b2
        b = b1 if l == 1 else b2
        k = (d[:, 2] * b + d[:, 1]) * b + d[:, 0]
        new_node = child_base + k
        step = ~done & (lvl_q >= l)
        node = np.where(step, new_node, node)
        nlvl = np.where(step, l, nlvl)
        origin = np.where(step[:, None], origin + d * spl[l], origin)
        cb = cchild[np.clip(new_node, 0, n - 1)]
        done = done | (step & ((cb == -1) | (lvl_q == l)))
        child_base = np.where(~done & step, cb, child_base)

    cbase_final = np.where(outside, -1, cchild[np.clip(node, 0, n - 1)])
    node = np.where(outside, -1, node)

    # only leaf-cell rows are ever used (rays traverse leaves); interior
    # rows are marked unusable
    leaf_row = np.repeat(cchild == -1, 6)
    node = np.where(leaf_row, node, -2)
    cbase_final = np.where(leaf_row, cbase_final, -2)

    if validate:
        # grading check: every face-adjacent child of an interior nbr node
        # must be a leaf (otherwise one descent step is not enough)
        interior = leaf_row & ~outside & (cbase_final >= 0)
        rows = np.flatnonzero(interior)
        if rows.size:
            ax = (rows % 6) // 2
            pos_face = (rows % 6) % 2 == 1  # cell leaves through +ax ⇒ enter
            # nbr from its -ax side ⇒ children with digit 0 on ax (and b2-1
            # for the opposite case)
            dg_ax = np.where(pos_face, 0, b2 - 1)
            base_k = cbase_final[rows]
            o1, o2 = np.arange(b2), np.arange(b2)
            for da in range(b2):
                for db in range(b2):
                    d3 = np.empty((rows.size, 3), dtype=np.int64)
                    d3[np.arange(rows.size), ax] = dg_ax
                    other = [(0, 1, 2), (1, 0, 2), (2, 0, 1)]
                    for a in range(3):
                        m = ax == a
                        d3[m, other[a][1]] = da
                        d3[m, other[a][2]] = db
                    k = (d3[:, 2] * b2 + d3[:, 1]) * b2 + d3[:, 0]
                    ch = base_k + k
                    if np.any(cchild[np.clip(ch, 0, n - 1)] != -1):
                        raise ValueError(
                            "grid is not graded (neighbouring leaves differ "
                            "by more than one level); nav table unusable"
                        )

    out = np.zeros((n * 6, NAV_W), dtype=np.int32)
    out[:, 0] = node
    out[:, 1] = np.where(outside, -1, cbase_final)
    out[:, 2] = nlvl
    out[:, 3:6] = np.where(outside[:, None], 0, origin)
    return out


# ---------------------------------------------------------------------------
# numpy mirrors (host-side tooling: grid builder, I/O checks)
# ---------------------------------------------------------------------------


def np_point_to_cell(cchild, base, max_lvl, modelsize, pos):
    """Host/numpy version of point_to_cell for builder-time queries."""
    b1, b2 = base
    pos = np.atleast_2d(np.asarray(pos, dtype=np.float64))
    n = pos.shape[0]
    csizes = [modelsize] + [modelsize / (b1 * b2 ** (l - 1)) for l in range(1, max_lvl + 1)]
    norm = pos + modelsize / 2.0
    cell = np.zeros(n, dtype=np.int64)
    clvl = np.zeros(n, dtype=np.int64)
    child_base = np.full(n, cchild[0], dtype=np.int64)
    done = np.zeros(n, dtype=bool)
    for l in range(1, max_lvl + 1):
        b = b1 if l == 1 else b2
        digit = np.clip(np.floor(norm / csizes[l]).astype(np.int64), 0, b - 1)
        norm = norm - digit * csizes[l]
        k = (digit[:, 2] * b + digit[:, 1]) * b + digit[:, 0]
        new_cell = child_base + k
        cell = np.where(done, cell, new_cell)
        clvl = np.where(done, clvl, l)
        cb = cchild[np.clip(new_cell, 0, len(cchild) - 1)]
        newly = ~done & (cb == -1)
        done |= newly
        child_base = np.where(done, child_base, cb)
    return cell, clvl


def compute_cindex(cchild, lvl, ccoord, base, max_lvl, modelsize):
    """Encode the reference's int64 cindex bitcodes from cell coordinates.

    Follows subdivide_cell (create_adap_grid_trustI.f90:344-348): the level-l
    child code ``(iz*b+iy)*b+ix+1`` is stored in a bit field of width
    ceil(log2(b^3+1)) shifted past the fields of levels < l.
    """
    # basediv = smallest power of two strictly greater than base^3
    # (set_base, smooth_grid_routines.f90:622-649)
    b1, b2 = base
    j = 0
    while not (b1**3 < (1 << j)):
        j += 1
    basediv1 = 1 << j
    j = 0
    while not (b2**3 < (1 << j)):
        j += 1
    basediv2 = 1 << j

    n = len(cchild)
    cindex = np.zeros(n, dtype=np.int64)
    csizes = [modelsize] + [modelsize / (b1 * b2 ** (l - 1)) for l in range(1, max_lvl + 1)]
    norm = np.asarray(ccoord, dtype=np.float64) + modelsize / 2.0
    shift = np.ones(n, dtype=np.int64)
    for l in range(1, max_lvl + 1):
        b = b1 if l == 1 else b2
        digit = np.clip(np.floor(norm / csizes[l]).astype(np.int64), 0, b - 1)
        norm = norm - digit * csizes[l]
        k = (digit[:, 2] * b + digit[:, 1]) * b + digit[:, 0] + 1
        active = lvl >= l
        cindex = np.where(active, cindex + k * shift, cindex)
        shift = shift * (basediv1 if l == 1 else basediv2)
    cindex[0] = 0
    return cindex
