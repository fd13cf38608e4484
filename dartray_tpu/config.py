"""Run configuration: dataclass with the reference's namelist keys + parser.

The reference reads three Fortran namelists — dartray_input_strings /
_var / _logical (io_routines.f90:176-178) — with sentinel defaults
(input_initialize io_routines.f90:2654) and range checks (check_input
io_routines.f90:2745).  This module provides the same key set as a typed
dataclass and a parser for the reference's ``.in`` files so existing inputs
run unmodified.
"""
from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Tuple


@dataclasses.dataclass
class RTConfig:
    # --- strings (dartray_input_strings, io_routines.f90:176) ---
    label_model_out: str = ""
    label_model_out_i_obs: str = ""
    label_model_lambda_grid: str = ""
    file_dir_out: str = ""
    file_pos_obs: str = ""
    file_p_src: str = ""
    file_lambda_list: str = ""
    dir_runs: str = "./runs"
    dir_grid: str = "./"
    grid_file: str = ""
    rt_algorithm: str = "main"  # main|2D|dust|dust_2D|sed|sed_dust|i_obs|i_obs_dust|projection
    units_luminosity: str = "erg/s/Hz"  # or W/Hz
    units_csize: str = "pc"
    units_lambda: str = "um"
    dust_model: str = "TRUST"  # TRUST | DraineLi06 | user
    dust_opacity_tables: str = ""
    file_gra_fa: str = ""
    file_sil_fa: str = ""
    file_pah_neu_fa: str = ""
    file_pah_ion_fa: str = ""
    file_av_opacities: str = ""
    dust_heating_type: str = "eff"  # eff | equ | sto | sto_lib
    file_q_gra: str = ""
    file_q_sil: str = ""
    file_q_pah_neu: str = ""
    file_q_pah_ion: str = ""
    file_calorimetry_Gra: str = ""
    file_calorimetry_Sil: str = ""
    file_nbody_sph: str = ""
    file_stellar_library: str = ""
    stellar_library: str = ""
    param_to_project: str = "stellar_emission"
    file_param_src: str = ""

    # --- numeric (dartray_input_var, io_routines.f90:177) ---
    kp_sca_max: int = 1  # range [0,4] (check_input io:3016)
    rad_lim: float = 0.1  # range [0,2]
    accuracy: float = 0.1  # range [0,1]
    conv_en_lim: float = 0.01
    bm_par: int = 10  # range [0,1000]
    bm_par_sca: int = 5
    bm_par_max: int = 200  # >= 10*max(bm_par, bm_par_sca)
    lambda_ref: float = 1.0
    max_lambda_stars: float = -1.0
    min_lambda_dust: float = -1.0
    dist_obs: float = 1e4  # [pc]
    ind_i_obs: Optional[List[int]] = None
    ind_out_maps: Optional[List[int]] = None
    n_dust_size_qabs: Optional[List[int]] = None
    n_dust_wave_qabs: int = 0
    tau_cell_max: float = 0.0
    n_dust_temp_cal: Optional[List[int]] = None
    npixel_maps: int = 100
    map_size_factor: float = 1.8
    kp_maps: int = 3
    x_wall_coord: Tuple[float, float] = (0.0, 1.0)
    y_wall_coord: Tuple[float, float] = (0.0, 1.0)
    z_wall_coord: Tuple[float, float] = (0.0, 1.0)
    z_sun: float = 0.018
    max_sca_iterations: int = 1000
    n_int_rf_bins: int = 10

    # --- logical (dartray_input_logical, io_routines.f90:178) ---
    print_scaspe_tot: bool = False
    print_output_part1: bool = False
    print_output_part2: bool = False
    print_scaspe_part2: bool = False
    restore_file_mpi: bool = False
    use_lambda_grid: bool = False
    use_dir_out: bool = False
    use_pos_obs: bool = False
    use_p_src: bool = False
    print_psel_av: bool = False
    sequential_scattering: bool = False
    print_sed: bool = True
    input_av_opacities: bool = False
    no_communications: bool = True
    no_dust_rt: bool = False
    only_direct_rt: bool = False
    test_run: bool = False
    print_maps: bool = False
    print_maps_in: bool = False
    x_wall_on: bool = False
    y_wall_on: bool = False
    z_wall_on: bool = False
    use_stellar_library: bool = False
    limit_scattering_iterations: bool = False

    def validate(self):
        """Range checks per check_input (io_routines.f90:2745-3305)."""
        errs = []
        if not (0 <= self.kp_sca_max <= 4):
            errs.append("kp_sca_max must be in [0,4]")
        if not (0.0 <= self.rad_lim <= 2.0):
            errs.append("rad_lim must be in [0,2]")
        if not (0.0 <= self.accuracy <= 1.0):
            errs.append("accuracy must be in [0,1]")
        if not (0 <= self.bm_par <= 1000):
            errs.append("bm_par must be in [0,1000]")
        if not (0 <= self.bm_par_sca <= 1000):
            errs.append("bm_par_sca must be in [0,1000]")
        if self.bm_par_max < 10 * max(self.bm_par, self.bm_par_sca):
            errs.append("bm_par_max must be >= 10*max(bm_par, bm_par_sca)")
        if self.rt_algorithm not in (
            "main", "2D", "dust", "dust_2D", "sed", "sed_dust",
            "i_obs", "i_obs_dust", "projection",
        ):
            errs.append(f"unknown rt_algorithm {self.rt_algorithm!r}")
        if self.dust_heating_type not in ("eff", "equ", "sto", "sto_lib", "not_provided"):
            errs.append(f"unknown dust_heating_type {self.dust_heating_type!r}")
        if self.no_communications and self.sequential_scattering is False:
            # the reference *requires* sequential_scattering in
            # no_communications mode (rt_routines.f90:319); this rebuild
            # has no such race so both are accepted.
            pass
        if errs:
            raise ValueError("invalid config: " + "; ".join(errs))
        return self


_BOOL = {".true.": True, ".false.": False, "t": True, "f": False}


def _parse_value(raw: str):
    raw = raw.strip().rstrip(",").strip()
    low = raw.lower()
    if low in _BOOL:
        return _BOOL[low]
    if raw.startswith(("'", '"')):
        return raw.strip("'\"")
    parts = [p for p in re.split(r"[,\s]+", raw) if p]
    vals = []
    for p in parts:
        pl = p.lower()
        if pl in _BOOL:
            vals.append(_BOOL[pl])
            continue
        try:
            if re.fullmatch(r"[+-]?\d+", p):
                vals.append(int(p))
            else:
                vals.append(float(p.replace("d", "e").replace("D", "E")))
        except ValueError:
            vals.append(p.strip("'\""))
    if len(vals) == 1:
        return vals[0]
    return vals


def parse_namelist_file(path: str) -> dict:
    """Parse all groups of a Fortran namelist file into one flat dict."""
    out = {}
    with open(path) as f:
        text = f.read()
    # strip comments (! to end of line), keep strings simple
    lines = []
    for line in text.splitlines():
        if "!" in line:
            line = line.split("!", 1)[0]
        lines.append(line)
    text = "\n".join(lines)
    for m in re.finditer(r"&(\w+)(.*?)(?:^|\n)\s*/", text, re.S):
        body = m.group(2)
        for am in re.finditer(r"([A-Za-z_]\w*)\s*=\s*([^=]*?)(?=(?:\n\s*[A-Za-z_]\w*\s*=)|\Z)", body, re.S):
            key = am.group(1)
            out[key] = _parse_value(am.group(2))
    return out


def load_config(path: str) -> RTConfig:
    """Load an RTConfig from a reference-format ``.in`` namelist file."""
    raw = parse_namelist_file(path)
    fields = {f.name: f for f in dataclasses.fields(RTConfig)}
    kwargs = {}
    for k, v in raw.items():
        if k not in fields:
            continue  # model-specific namelist keys are handled by the models
        ftype = fields[k].type
        if ftype in ("Optional[List[int]]",):
            v = [int(x) for x in (v if isinstance(v, list) else [v])]
        elif ftype in ("Tuple[float, float]",):
            v = tuple(float(x) for x in (v if isinstance(v, list) else [v]))
        elif ftype == "bool" and not isinstance(v, bool):
            v = bool(v)
        elif ftype == "int" and not isinstance(v, bool):
            v = int(v)
        elif ftype == "float":
            v = float(v)
        kwargs[k] = v
    return RTConfig(**kwargs).validate()
