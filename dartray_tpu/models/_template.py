"""Skeleton for a new model family (docs/ADDING_A_MODEL.md).

Equivalent of the reference's PROGRAM_TEMPLATES/
(user_routines_model.f90 + create_adap_grid_model.f90 + dartray_model.f90):
copy this file to models/<name>.py, fill in the physics, then register
<name> in cli.MODELS / cli._model_sources / cli.cmd_create_grid.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..grid.builder import build_grid


@dataclasses.dataclass
class TemplateParams:
    """The model's namelist parameters (&template_input_var etc.);
    keep the reference's key names so its input files run unmodified."""

    modelsize: float = 10.0
    base: tuple = (10, 2)
    max_lvl: int = 4
    min_lvl: int = 1
    max_ncell: int = 4_000_000
    max_dtau: float = 0.5
    max_dlum: float = 0.05
    # ... model-specific geometry parameters ...


def parse_template(raw: dict) -> TemplateParams:
    """Read the model's namelist groups from config.read_namelists output."""
    g = raw.get("template_input_var", {})
    p = TemplateParams()
    for k in ("modelsize", "max_dtau", "max_dlum"):
        if k in g:
            setattr(p, k, float(g[k]))
    if "base" in g:
        p.base = tuple(int(x) for x in np.atleast_1d(g["base"]))
    for k in ("max_lvl", "min_lvl", "max_ncell"):
        if k in g:
            setattr(p, k, int(float(g[k])))
    return p


def av_rho_dust(p: TemplateParams, ccoord, csize):
    """CELL-AVERAGED extinction coefficient [1/pc] at lambda_ref for cell
    centers (n,3) + sizes (n,): the av_rho_dust_* equivalent.  Vectorize;
    use exact closed-form volume averages where the geometry allows
    (models/trustI.py:30 shows the axis-aligned-slab overlap)."""
    raise NotImplementedError


def av_dens_stars(p: TemplateParams, ccoord, csize):
    """Cell-averaged stellar emissivity at lambda_ref (same contract)."""
    raise NotImplementedError


def build_template_grid(p: TemplateParams):
    """create_adap_grid_<model> equivalent: adaptive octree build with the
    model's subdivision predicate; grading is enforced by build_grid."""

    def dens_fn(centers, csize):
        return av_rho_dust(p, centers, csize), av_dens_stars(p, centers, csize)

    def subdivision(centers, csize, level, dens, dens_stars):
        tau = dens * csize
        return tau > p.max_dtau  # + max_dlum / geometric criteria

    return build_grid(
        dens_fn, subdivision, base=p.base, max_lvl=p.max_lvl,
        min_lvl=p.min_lvl, max_ncell=p.max_ncell, modelsize=p.modelsize,
    )


def source_luminosity(lambda_um, *model_args):
    """set_<model> equivalent for point sources: (n_src, L) luminosities
    in the run's luminosity units."""
    raise NotImplementedError
