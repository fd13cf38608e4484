"""Command-line drivers.

Rebuild of the reference executables (L9, SURVEY.md §2.3):
  dartray_<model> <input.in>           -> python -m dartray_tpu.cli run <model> <input.in>
  create_adap_grid_<model> <input.in>  -> python -m dartray_tpu.cli create-grid <model> <input.in>

The input files are the reference's Fortran namelist files (dartray_input_*
plus per-model groups); paths inside are resolved relative to the current
working directory exactly like the reference.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np


def _load_inputs(path):
    from .config import load_config, parse_namelist_file

    cfg = load_config(path)
    raw = parse_namelist_file(path)
    return cfg, raw


def _read_observers(cfg, raw):
    dir_out = None
    pos_obs = None
    if cfg.use_dir_out and cfg.file_dir_out:
        dir_out = np.atleast_2d(
            np.loadtxt(os.path.join(cfg.dir_grid, cfg.file_dir_out), skiprows=1)
        )
    if cfg.use_pos_obs and cfg.file_pos_obs:
        pos_obs = np.atleast_2d(
            np.loadtxt(os.path.join(cfg.dir_grid, cfg.file_pos_obs), skiprows=1)
        )
    return dir_out, pos_obs


def _opacity_dir():
    """Resolve the DUST_OPACITY directory (the reference reads it relative
    to the working directory, load_opacity_param sed_routines.f90:1117)."""
    for cand in ("./data/DUST_OPACITY", "./DUST_OPACITY"):
        if os.path.isdir(cand):
            return cand
    return None


def _prepare_common(cfg, raw):
    from .wavelength import make_wavelength_grid, read_lambda_list
    from . import dust as D

    lam = read_lambda_list(os.path.join(cfg.dir_grid, cfg.file_lambda_list))
    wl = make_wavelength_grid(lam, cfg.max_lambda_stars, cfg.min_lambda_dust)
    dustm = D.prepare_dust_model(cfg, wl.lambda_um, _opacity_dir())
    return wl, dustm


MODELS = ("trustI", "magtar", "galaxy", "Nbody_SPH", "2dto3d")


def _model_sources(model, cfg, raw, grid, wl):
    """Per-model source setup (the set_<model> routines)."""
    p_src_pos = p_src_lum = None
    dens_stars = None
    if cfg.use_p_src and cfg.file_p_src:
        p_src_pos = np.atleast_2d(
            np.loadtxt(os.path.join(cfg.dir_grid, cfg.file_p_src), skiprows=1)
        )
    sl = wl.stellar_slice
    if model == "trustI":
        from .models import trustI

        if p_src_pos is not None:
            tl, tf = trustI.read_planck_table(
                os.path.join(cfg.dir_grid, "BB_T10000_L100000.dat")
            )
            lum = trustI.source_luminosity(wl.lambda_um[sl], tl, tf)
            p_src_lum = np.tile(lum[None, :], (len(p_src_pos), 1))
    elif model == "magtar":
        from .models import magtar

        if p_src_pos is not None:
            teff, lbol = magtar.read_param_src(
                os.path.join(cfg.dir_grid, cfg.file_param_src)
            )
            p_src_lum = magtar.source_luminosity(wl.lambda_um[sl], teff, lbol)
    elif model in ("galaxy", "Nbody_SPH", "2dto3d"):
        # all emission lives in the grid (cell emissivities; the reference
        # drivers dartray_galaxy/dartray_Nbody_SPH define no point sources)
        pass
    else:
        raise SystemExit(f"unknown model {model!r} (available: {MODELS})")
    ds = np.asarray(grid.dens_stars_ref)
    if ds.sum() > 0:
        # cell emissivities from the grid file, scaled flat across lambda;
        # per-lambda emissivities come from the lambda grids when
        # use_lambda_grid is set (cmd_run)
        dens_stars = np.tile(ds[:, None], (1, wl.lnum_stars))
    return dens_stars, p_src_pos, p_src_lum


def cmd_run(model: str, input_file: str):
    # Multi-host (P8): jax.distributed.initialize() must run before ANY
    # jax call that can initialize the XLA backend — check_memory's
    # device query below would otherwise do so and the late initialize
    # raises RuntimeError (initialize_mpi is likewise the first call in
    # the reference, io_routines.f90:3610).
    if os.environ.get("DARTRAY_MULTIHOST", "0") not in ("", "0"):
        from .parallel import distributed as DIST

        DIST.initialize()
    from . import pipeline as P
    from .grid.io import read_grid
    from . import io_output as OUT

    cfg, raw = _load_inputs(input_file)
    wl, dustm = _prepare_common(cfg, raw)
    grid = read_grid(os.path.join(cfg.dir_grid, cfg.grid_file))
    dir_out, pos_obs = _read_observers(cfg, raw)
    dens_stars, p_src_pos, p_src_lum = _model_sources(model, cfg, raw, grid, wl)

    dens_lambda = None
    if cfg.use_lambda_grid:
        # per-wavelength dens/dens_stars from the lambda-grid files
        # (read_lambda_grid, io_routines.f90:397-498)
        from .grid.io import read_lambda_grids
        import dataclasses as _dc

        dens_arr, ds_arr, dens_ref = read_lambda_grids(
            cfg.dir_grid, cfg.label_model_lambda_grid,
            wl.lambda_um[wl.stellar_slice], grid.n_cells, cfg.lambda_ref,
        )
        grid = _dc.replace(grid, dens_ref=dens_ref)
        dens_lambda = dens_arr
        dens_stars = ds_arr if ds_arr.sum() > 0 else dens_stars

    os.makedirs(cfg.dir_runs, exist_ok=True)
    files = OUT.OutputFiles(
        cfg.dir_runs, cfg.label_model_out, wl.lambda_um[wl.stellar_slice]
    )

    t0 = time.time()
    algo = cfg.rt_algorithm
    if algo == "projection":
        return cmd_projection(cfg, grid, wl, dustm, dens_stars, p_src_pos, p_src_lum,
                              dir_out, pos_obs, files)
    if algo in ("sed", "sed_dust"):
        return cmd_sed(cfg, grid, wl, dustm, p_src_pos, dir_out, files)
    if algo in ("i_obs", "i_obs_dust"):
        return cmd_iobs(cfg, grid, wl, dustm, dens_stars, p_src_pos, p_src_lum,
                        dir_out, pos_obs, files, dens_lambda)

    # run-parameter dump + memory preflight (write_file_info io:854,
    # check_memory io:3540)
    OUT.write_file_info(files, cfg, {
        "model": model, "n_cells": grid.n_cells,
        "n_point_sources": 0 if p_src_pos is None else len(p_src_pos),
    })
    from .rt import scattering as SC
    mem = OUT.check_memory(
        grid.n_cells, wl.lnum_stars,
        scfg=SC.ScaspeConfig.from_run_config(cfg, dustm, wl, dir_out),
        n_dir=0 if dir_out is None else len(dir_out),
    )
    print(f"# memory estimate: {mem['total_bytes']/2**30:.2f} GiB "
          f"(scaspe {mem['scaspe_bytes']/2**30:.2f} GiB)")

    two_d = algo in ("2D", "dust_2D")
    # shard the field stages over every LOCAL device (P1+P6).  Multi-host
    # (P8, initialize_mpi io_routines.f90:3610): set DARTRAY_MULTIHOST=1
    # and the coordination env vars (DARTRAY_COORDINATOR=host:port,
    # DARTRAY_NUM_PROCS, DARTRAY_PROC_ID — or nothing on clusters that
    # JAX auto-detects), then run the SAME command in every process; each
    # process traces a rank-strided slice of the sources on its local
    # mesh and the accumulators reduce once per stage
    # (parallel/distributed.py).  A 'wave' axis additionally shards the
    # scaspe wavelength axis (P3): DARTRAY_WAVE_SHARDS=n.
    import os as _os

    import jax

    if _os.environ.get("DARTRAY_MULTIHOST", "0") not in ("", "0"):
        from .parallel import distributed as DIST

        DIST.initialize()  # no-op: cmd_run already initialized at entry
        print(f"# multihost: process {jax.process_index()}/"
              f"{jax.process_count()} (rank-strided sources + stage "
              "reductions; local devices shard rays/wave)")
    # under multihost each process drives its LOCAL device mesh (P1/P3)
    # while the source split + stage reductions span processes (P8)
    devs = jax.local_devices()
    mesh = None
    if len(devs) > 1:
        from .parallel import mesh as PM

        n_wave = int(_os.environ.get("DARTRAY_WAVE_SHARDS", "1"))
        if n_wave > 1 and len(devs) % n_wave == 0:
            mesh = PM.make_mesh(len(devs) // n_wave, n_wave, devices=devs)
            print(f"# sharding rays x wave over "
                  f"{len(devs)} devices ({n_wave} wave shards)")
        else:
            mesh = PM.ray_mesh(devices=devs)
            print(f"# sharding rays over {len(devs)} devices")
    print(f"# running {algo} RT: {grid.n_cells} cells, "
          f"L_stars={wl.lnum_stars}, L_dust={wl.lnum_dust}")
    res = P.run_main(
        grid, cfg, wl, dustm,
        dens_stars_arr=dens_stars, p_src_pos=p_src_pos, p_src_lum=p_src_lum,
        dir_out=dir_out, pos_obs=pos_obs, two_d=two_d,
        dens_lambda=dens_lambda, files=files, mesh=mesh,
    )
    print(f"# stellar RT done in {time.time()-t0:.1f}s, "
          f"{res.iterations} scattering iterations, converged={res.converged}")

    # outputs (make_output equivalents)
    if cfg.print_output_part2 or True:
        OUT.write_field_per_lambda(files, "ufield", res.u_final)
    if res.i_obs is not None:
        OUT.write_field_per_lambda(files, "i_obs", res.i_obs, ind=cfg.ind_i_obs)
    if res.i_obs_in is not None:
        OUT.write_field_per_lambda(files, "i_obs_in", res.i_obs_in, ind=cfg.ind_i_obs)
    if res.sed_tot is not None:
        OUT.write_sed(files, res.sed_tot)
        if res.direct.sed_direct is not None:
            OUT.write_sed(files, res.direct.sed_direct, part2=True)
    if res.maps_tot is not None:
        lam_idx = cfg.ind_out_maps or list(range(wl.lnum_stars))
        OUT.write_maps(files, res.maps_tot, wl.lambda_um[lam_idx])

    # internal-observer HEALPix maps (map_in_projection,
    # visual_routines.f90:917-1076)
    if cfg.print_maps_in and res.i_obs_in is not None and pos_obs is not None:
        from .vis import maps_internal as MIN

        psrc_pos = p_src_pos if p_src_pos is not None and len(p_src_pos) else None
        psrc_host = None
        if psrc_pos is not None:
            from .rt import engine as E

            psrc_host = E.point_source_set(grid, p_src_pos, p_src_lum).cell
        maps_in = np.stack([
            MIN.make_map_in(grid, res.i_obs_in[:, j, :], ro, cfg.kp_maps,
                            src_pos=psrc_pos, src_host=psrc_host)
            for j, ro in enumerate(np.asarray(pos_obs))
        ])
        OUT.write_maps(files, maps_in, wl.lambda_um[wl.stellar_slice],
                       internal=True)

    # scattering source function output (print_scaspe_tot)
    if cfg.print_scaspe_tot and res.scaspe_tot is not None:
        from .rt import scattering as SC

        scfg_out = SC.ScaspeConfig.make(
            cfg.kp_sca_max, dustm.gsca[wl.stellar_slice],
            None if cfg.rt_algorithm in ("2D", "dust_2D") else dir_out,
        )
        OUT.write_scaspe(files, scfg_out, res.scaspe_tot, kind="scaspe_tot")

    # lost-luminosity + ray telemetry
    tot_rad_en = np.zeros(wl.lnum_stars)
    if dens_stars is not None:
        tot_rad_en += (np.asarray(dens_stars)
                       * (np.asarray(grid.csize) ** 3)[:, None]).sum(axis=0)
    if p_src_lum is not None:
        tot_rad_en += np.asarray(p_src_lum).sum(axis=0)
    OUT.write_lum_lost(files, res.lum_lost, tot_rad_en)
    frac = res.lum_lost / np.maximum(tot_rad_en, 1e-300)
    if frac.max() > 0.01:
        print(f"# WARNING: lost luminosity fraction up to {frac.max():.1%} "
              "(> 1%; consider higher accuracy/bm_par)")
    if cfg.print_psel_av:
        OUT.write_psel_av(files, res.direct.stats, wl.lambda_um[wl.stellar_slice])

    # dust emission RT
    if not cfg.no_dust_rt and not wl.no_dust_rt and cfg.dust_heating_type in (
            "eff", "equ", "sto", "sto_lib"):
        t1 = time.time()
        cal = None
        if cfg.dust_heating_type in ("sto", "sto_lib"):
            from . import dust as D
            odir = _opacity_dir()
            if odir is None or dustm.qabs_fa is None:
                raise SystemExit(
                    f"'{cfg.dust_heating_type}' heating requires a "
                    "grain-level dust model (input_av_opacities is "
                    "effective-only) and a DUST_OPACITY directory with "
                    "calorimetry tables (./data/DUST_OPACITY or "
                    "./DUST_OPACITY)")
            cal = D.load_calorimetry(odir, n_comp=dustm.qabs_fa.shape[0])
            cal = D.add_planck_avg_qabs(
                cal, dustm, wl.lambda_si, wl.delta_lambda_bin)
        dres = P.run_dust_rt(grid, cfg, wl, dustm, res.u_final,
                             dir_out=dir_out, pos_obs=pos_obs, cal=cal,
                             two_d=two_d, mesh=mesh)
        print(f"# dust RT done in {time.time()-t1:.1f}s, "
              f"{dres.iterations} heating iterations, converged={dres.converged}")
        dfiles = OUT.OutputFiles(
            cfg.dir_runs, cfg.label_model_out, wl.lambda_um[wl.dust_slice],
            chext=f"_dust_{cfg.dust_heating_type}",
        )
        OUT.write_field_per_lambda(dfiles, "ufield", dres.u_dust)
        if dres.sed_dust is not None:
            OUT.write_sed(dfiles, dres.sed_dust)
        if dres.maps_dust is not None:
            lam_idx = [i for i in (cfg.ind_out_maps or range(wl.lnum_tot))
                       if wl.i_lambda_dust[0] <= i <= wl.i_lambda_dust[1]]
            OUT.write_maps(dfiles, dres.maps_dust, wl.lambda_um[lam_idx])

    print(f"# all done in {time.time()-t0:.1f}s; outputs in {cfg.dir_runs}")
    return 0


def cmd_sed(cfg, grid, wl, dustm, p_src_pos, dir_out, files):
    """'sed'/'sed_dust' rt_algorithm: recompute integrated SEDs (and maps)
    from the i_obs files of a previous run (dartray_sed,
    dartray_hub.f90:171-207)."""
    from . import pipeline as P
    from . import io_output as OUT
    from .rt import engine as E

    lambda_range = "dust" if cfg.rt_algorithm == "sed_dust" else "stars"
    if lambda_range == "dust":
        files = OUT.OutputFiles(
            cfg.dir_runs, cfg.label_model_out, wl.lambda_um[wl.dust_slice],
            chext=f"_dust_{cfg.dust_heating_type}",
        )
    n_point = 0 if p_src_pos is None else len(p_src_pos)
    src_host = None
    if n_point and lambda_range == "stars":
        src_host = E.point_source_set(
            grid, p_src_pos, np.zeros((n_point, wl.lnum_stars))
        ).cell
    sed, maps_out = P.run_sed_algorithm(
        grid, cfg, wl, files, n_point if lambda_range == "stars" else 0,
        src_host, lambda_range, dir_out,
    )
    OUT.write_sed(files, sed)
    if maps_out is not None:
        OUT.write_maps(files, maps_out, files.lambda_um)
    print(f"# sed recomputed from i_obs files -> {files.sed}")
    return 0


def cmd_iobs(cfg, grid, wl, dustm, dens_stars, p_src_pos, p_src_lum,
             dir_out, pos_obs, files, dens_lambda=None):
    """'i_obs'/'i_obs_dust' rt_algorithm: observer intensities for (possibly
    new) directions from the saved scattering source function, without
    redoing the RT (dartray_i_obs, dartray_hub.f90:125-168)."""
    from . import pipeline as P
    from . import io_output as OUT
    from .rt import scattering as SC

    lambda_range = "dust" if cfg.rt_algorithm == "i_obs_dust" else "stars"
    sl = wl.stellar_slice if lambda_range == "stars" else wl.dust_slice
    if lambda_range == "dust":
        files = OUT.OutputFiles(
            cfg.dir_runs, cfg.label_model_out, wl.lambda_um[sl],
            chext=f"_dust_{cfg.dust_heating_type}",
        )
    # read the saved scaspe_tot; only the HEALPix pixels are reused for the
    # new directions (assign_src_lum, rt_routines.f90:3043)
    scfg = SC.ScaspeConfig.make(cfg.kp_sca_max, dustm.gsca[sl], None)
    scaspe_tot = OUT.read_scaspe(files, scfg, grid.n_cells, kind="scaspe_tot")
    i_obs, i_obs_in = P.run_iobs_algorithm(
        grid, cfg, wl, dustm, scaspe_tot, scfg, dir_out=dir_out,
        pos_obs=pos_obs, dens_stars_arr=dens_stars, p_src_pos=p_src_pos,
        p_src_lum=p_src_lum, lambda_range=lambda_range,
    )
    label_out = cfg.label_model_out_i_obs or (cfg.label_model_out + "_i_obs")
    ofiles = OUT.OutputFiles(cfg.dir_runs, label_out, files.lambda_um,
                             chext=files.chext)
    if i_obs is not None:
        OUT.write_field_per_lambda(ofiles, "i_obs", i_obs, ind=cfg.ind_i_obs)
    if i_obs_in is not None:
        OUT.write_field_per_lambda(ofiles, "i_obs_in", i_obs_in,
                                   ind=cfg.ind_i_obs)
    print(f"# i_obs recomputed from scaspe_tot -> {ofiles.dir_runs}")
    return 0


def cmd_projection(cfg, grid, wl, dustm, dens_stars, p_src_pos, p_src_lum,
                   dir_out, pos_obs, files):
    """'projection' rt_algorithm: dust-free maps of the intrinsic stellar
    emission or of the optical depth (assign_i_obs_to_project,
    rt_routines.f90:5318-5367)."""
    from . import io_output as OUT
    from .vis import maps as MAPS
    from .rt import engine as E

    n_ps = len(p_src_pos) if p_src_pos is not None else 0
    nsid = grid.n_cells + n_ps
    L = wl.lnum_stars
    csize = np.asarray(grid.csize)
    i_obs = np.zeros((nsid, L))
    if cfg.param_to_project == "stellar_emission":
        if dens_stars is not None:
            i_obs[: grid.n_cells] = dens_stars * csize[:, None] / (4 * np.pi)
        if n_ps:
            psrc = E.point_source_set(grid, p_src_pos, p_src_lum)
            i_obs[grid.n_cells :] = p_src_lum / (csize[psrc.cell] ** 2)[:, None] / (4 * np.pi)
        chext = "_stars_em"
    elif cfg.param_to_project == "optical_depth":
        dens_arr = np.asarray(grid.dens_ref)[:, None] * (
            dustm.kext[wl.stellar_slice] / dustm.kext_ref
        )[None, :]
        i_obs[: grid.n_cells] = dens_arr * csize[:, None]
        chext = "_opt_depth"
    else:
        raise SystemExit(f"unknown param_to_project {cfg.param_to_project!r}")

    maps_out = []
    psrc = E.point_source_set(grid, p_src_pos, p_src_lum) if n_ps else None
    for th, ph in np.asarray(dir_out) if dir_out is not None else []:
        m = MAPS.make_map(
            grid, i_obs[:, None, :][:, 0, :], th, ph, cfg.npixel_maps,
            cfg.map_size_factor,
            src_pos=p_src_pos if n_ps else None,
            src_host=psrc.cell if n_ps else None,
        )
        maps_out.append(m)
    files = OUT.OutputFiles(cfg.dir_runs, cfg.label_model_out,
                            wl.lambda_um[wl.stellar_slice], chext=chext)
    if maps_out:
        OUT.write_maps(files, np.stack(maps_out), wl.lambda_um[wl.stellar_slice])
    print(f"# projection maps written to {cfg.dir_runs}")
    return 0


def _stellar_library_path(raw):
    """Resolve the SSP library HDF5 (read_stellar_library,
    io_routines.f90:4165): 'user' takes file_stellar_library verbatim,
    named libraries resolve under STELLAR_LIBRARIES/."""
    name = raw.get("stellar_library", "")
    if name == "user" or not name:
        return raw["file_stellar_library"]
    fname = f"table_lum_mass_vs_age_met_{name}.h5"
    for root in ("./data/STELLAR_LIBRARIES", "./STELLAR_LIBRARIES"):
        for sub in (name.split("_")[0], name, "maraston2005"):
            cand = os.path.join(root, sub, fname)
            if os.path.exists(cand):
                return cand
    raise SystemExit(
        f"stellar library {name!r} not found under ./data/STELLAR_LIBRARIES "
        "(available: maraston2005_kr_rhb, or stellar_library='user' with "
        "file_stellar_library=<path>)"
    )


def _lambda_grid_range(raw, lambda_um):
    """Wavelength indices [i0, i1] of the lambda-grid loop
    (create_adap_grid_galaxy.f90:107-108)."""
    lam = np.asarray(lambda_um)
    i0 = int(np.argmin(np.abs(lam - float(raw.get("lambda_min", lam[0]))) / lam))
    i1 = int(np.argmin(np.abs(lam - float(raw.get("lambda_max", lam[-1]))) / lam))
    return i0, i1


def _write_lambda_grids(dir_grid, label, lambda_um, i0, i1, dens_arr, ds_arr):
    from .grid.io import lambda_grid_name, write_lambda_grid

    for k, il in enumerate(range(i0, i1 + 1)):
        path = os.path.join(dir_grid, lambda_grid_name(label, float(lambda_um[il])))
        write_lambda_grid(path, dens_arr[:, k], ds_arr[:, k])
    print(f"# {i1 - i0 + 1} lambda grids written to {dir_grid}")


def cmd_create_grid(model: str, input_file: str):
    from .config import parse_namelist_file
    from .grid.io import write_grid
    from .wavelength import read_lambda_list

    raw = parse_namelist_file(input_file)
    base = tuple(int(b) for b in raw.get("base", [10, 2]))
    common = dict(
        base=base,
        max_lvl=int(raw.get("max_lvl", 4)),
        min_lvl=int(raw.get("min_lvl", 1)),
        modelsize=float(raw.get("modelsize", 10.0)),
        max_ncell=int(float(raw.get("max_ncell", 4e6))),
    )
    t0 = time.time()
    if model == "trustI":
        from .models import trustI

        grid = trustI.build_trustI_grid(
            tau_z=float(raw.get("tau_z", 0.01)),
            max_dtau=float(raw.get("max_dtau", 1e-4)),
            min_lvl_in=int(raw.get("min_lvl_in", 10)),
            **common,
        )
    elif model == "magtar":
        from .models import magtar

        grid = magtar.build_magtar_grid(
            dust_geometry=raw.get("dust_geometry", "shell"),
            tau_z=float(raw.get("tau_z", 0.48)),
            ax=float(raw.get("ax", 1.0)),
            by=float(raw.get("by", 1.0)),
            cz=float(raw.get("cz", 1.0)),
            elrad_width=float(raw.get("elrad_width", 0.1)),
            max_dtau=float(raw.get("max_dtau", 1e-2)),
            R_subd_lim=float(raw.get("R_subd_lim", 1e30)),
            **common,
        )
    elif model == "galaxy":
        from .models import galaxy as GX
        from . import dust as D

        dir_grid = raw.get("dir_grid", ".")
        gmodel, tau1, tau2 = GX.model_from_namelist(raw, dir_grid)
        lam = read_lambda_list(os.path.join(dir_grid, raw["file_lambda_list"]))
        dustm = D.load_effective_dust_model(
            raw["file_av_opacities"], lam,
            lambda_ref=float(raw.get("lambda_ref", 0.443)),
        )
        lambda_ref = float(raw.get("lambda_ref", 0.443))
        kext_B = np.interp(GX.B_BAND_UM, dustm.lambda_um, dustm.kext)
        kref = np.interp(lambda_ref, dustm.lambda_um, dustm.kext)
        gref = GX.set_dust_a0(gmodel, tau1, tau2, float(kref / kext_B))
        dens_fn = GX.make_galaxy_dens_fn(gref, lambda_ref)
        lnu_old, lnu_sf, lnu_b = gref.luminosities(np.asarray([lambda_ref]))
        lnu_tot = float(lnu_old[0] + lnu_sf[0] + lnu_b[0])
        sub_fn = GX.make_galaxy_subdivision_fn(
            float(raw.get("max_dtau", 0.01)), float(raw.get("max_dlum", 1e-6)),
            lnu_tot, float(raw.get("z_subd_lim", 0.0)),
            float(raw.get("R_subd_lim", 0.0)), common["max_lvl"],
        )
        from .grid.builder import build_grid

        grid = build_grid(dens_fn, sub_fn, **common)
        # lambda grids (create_adap_grid_galaxy.f90:100-146)
        i0, i1 = _lambda_grid_range(raw, lam)
        lam_sel = np.asarray(lam)[i0:i1 + 1]
        label = (raw.get("label_model_lambda_grid", "model") + "_"
                 + raw.get("grid_type", "all"))
        dens_arr = GX.galaxy_dens_arr(
            grid, gmodel, tau1, tau2, dustm.lambda_um, dustm.kext, lam_sel
        )
        ds_arr = GX.galaxy_dens_stars_arr(grid, gmodel, lam_sel)
        _write_lambda_grids(dir_grid, label, lam, i0, i1, dens_arr, ds_arr)
    elif model in ("Nbody_SPH", "nbody_sph"):
        from .models import nbody_sph as NB
        from . import dust as D

        dir_grid = raw.get("dir_grid", ".")
        parts = NB.load_particles(os.path.join(dir_grid, raw["file_nbody_sph"]))
        lib = NB.load_stellar_library(_stellar_library_path(raw))
        lam = read_lambda_list(os.path.join(dir_grid, raw["file_lambda_list"]))
        lambda_ref = float(raw.get("lambda_ref", 0.443))
        dustm = D.load_effective_dust_model(
            raw["file_av_opacities"], lam, lambda_ref=lambda_ref,
        )
        z_sun = float(raw.get("z_sun", 0.018))
        lum_ref = NB.star_luminosities(lambda_ref, parts, lib, z_sun)
        # pc^2/Msun of solar-metallicity gas (set_kext_gas, nbody.f90:100-111)
        kg_ref = float(raw.get("kext_gas_ref", 0.0)) or NB.kext_gas(
            float(dustm.kext_ref), dustm.tot_n_dust or 1.0
        )
        grid = NB.build_nbody_grid(
            parts, lum_ref, kg_ref,
            max_dtau=float(raw.get("max_dtau", 0.5)),
            max_dlum=float(raw.get("max_dlum", 1e-5)),
            **common,
        )
        i0, i1 = _lambda_grid_range(raw, lam)
        lam_sel = np.asarray(lam)[i0:i1 + 1]
        ds_arr = NB.nbody_dens_stars_arr(grid, parts, lib, lam_sel, z_sun)
        kref = np.interp(lambda_ref, dustm.lambda_um, dustm.kext)
        ratios = np.interp(lam_sel, dustm.lambda_um, dustm.kext) / kref
        dens_arr = np.asarray(grid.dens_ref)[:, None] * ratios[None, :]
        label = raw.get("label_model_lambda_grid", "model")
        _write_lambda_grids(dir_grid, label, lam, i0, i1, dens_arr, ds_arr)
    elif model == "2dto3d":
        from .models import twod3d as TD

        dir_grid = raw.get("dir_grid", ".")
        dir_2d = raw.get("dir_grid_2d", dir_grid)
        label_2d = raw["label_model_2d"]
        lam = read_lambda_list(os.path.join(dir_grid, raw["file_lambda_list"]))
        lambda_ref = float(raw.get("lambda_ref", lam[0]))
        i0, i1 = _lambda_grid_range(raw, lam)

        def tab_path(l):
            return os.path.join(dir_2d, f"{label_2d}_l{l:.3f}um.dat")

        g2_ref = TD.read_grid_2d(tab_path(float(lambda_ref)))
        grid = TD.build_2dto3d_grid(
            g2_ref,
            max_dtau=float(raw.get("max_dtau", 0.01)),
            max_dlum=float(raw.get("max_dlum", 1e-6)),
            **common,
        )
        lam_sel = np.asarray(lam)[i0:i1 + 1]
        centers = np.asarray(grid.ccoord)
        csize = np.asarray(grid.csize)
        leaf = np.asarray(grid.leaf_mask())
        dens_arr = np.zeros((grid.n_cells, len(lam_sel)))
        ds_arr = np.zeros((grid.n_cells, len(lam_sel)))
        for k, l in enumerate(lam_sel):
            g2 = TD.read_grid_2d(tab_path(float(l)))
            lum_k, dens_k = TD.cell_average(
                g2, centers[leaf], csize[leaf], common["modelsize"]
            )
            dens_arr[leaf, k] = dens_k
            ds_arr[leaf, k] = lum_k
        label = raw.get("label_model_lambda_grid", "model")
        _write_lambda_grids(dir_grid, label, lam, i0, i1, dens_arr, ds_arr)
    else:
        raise SystemExit(f"unknown model {model!r}")
    out = os.path.join(raw.get("dir_grid", "."), raw.get("grid_file", "grid.h5"))
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    write_grid(out, grid)
    leaves = int(np.sum(np.asarray(grid.leaf_mask())))
    print(f"# grid created: {grid.n_cells} cells ({leaves} leaves) "
          f"in {time.time()-t0:.1f}s -> {out}")
    return 0


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print(__doc__)
        return 2
    from .runtime import setup_compile_cache

    setup_compile_cache()
    cmd = argv[0]
    if cmd == "run":
        return cmd_run(argv[1], argv[2])
    if cmd == "create-grid":
        return cmd_create_grid(argv[1], argv[2])
    # default: treat as `run <model> <input>`
    return cmd_run(argv[0], argv[1])


if __name__ == "__main__":
    raise SystemExit(main())
