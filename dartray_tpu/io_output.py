"""Output files: reference-compatible naming, writers/readers, restart.

Rebuild of the output layer of io_routines.f90: filename scheme
(set_filenames io:720-794), per-wavelength HDF5 files for the big arrays,
stage-level restart detection (check_files io:893).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np


def wave_label(lambda_um: float) -> str:
    """Fortran "(F9.3)" trimmed (read_lambda_list io_routines.f90:2301)."""
    return f"{lambda_um:9.3f}".strip()


@dataclasses.dataclass
class OutputFiles:
    """Filename scheme of set_filenames (io_routines.f90:720-794)."""

    dir_runs: str
    label: str
    lambda_um: np.ndarray  # wavelengths of the current RT range
    chext: str = ""  # '' stellar, '_dust_<type>' dust, '_stars_em'/'_opt_depth' projection

    def _f(self, kind: str) -> str:
        return os.path.join(self.dir_runs, f"grid_{self.label}_{kind}{self.chext}.h5")

    def _fl(self, il: int, kind: str) -> str:
        lab = wave_label(self.lambda_um[il])
        return os.path.join(
            self.dir_runs, f"grid_{self.label}_l{lab}um_{kind}{self.chext}.h5"
        )

    # scalar files
    @property
    def sed(self):
        return self._f("sed")

    @property
    def sed_dir(self):
        return self._f("sed_dir")

    @property
    def lum_lost(self):
        return self._f("lum_lost")

    @property
    def lum_lost_part2(self):
        return self._f("lum_lost_part2")

    @property
    def maps(self):
        return self._f("maps")

    @property
    def maps_in(self):
        return self._f("maps_in")

    @property
    def info(self):
        return os.path.join(self.dir_runs, f"grid_{self.label}_info{self.chext}.dat")

    # per-wavelength files
    def u_fest_part1(self, il):
        return self._fl(il, "u_fest_part1")

    def ufield_part2(self, il):
        return self._fl(il, "ufield_part2")

    def ufield(self, il):
        return self._fl(il, "ufield")

    def i_obs(self, il):
        return self._fl(il, "i_obs")

    def i_obs_part2(self, il):
        return self._fl(il, "i_obs_part2")

    def i_obs_in(self, il):
        return self._fl(il, "i_obs_in")

    def i_obs_in_part2(self, il):
        return self._fl(il, "i_obs_in_part2")

    def scaspe_part2(self, il):
        return self._fl(il, "scaspe_part2")

    def scaspe_tot(self, il):
        return self._fl(il, "scaspe_tot")


def is_writer() -> bool:
    """True on the one process that writes output files.  Multi-process
    runs (P8) gate every file write on process 0 — the reference's
    main_prc gating (io_routines.f90 make_output paths) — so cooperating
    ranks never race on the same output files."""
    import jax

    try:
        return jax.process_index() == 0
    except Exception:
        return True


def _write_h5(path, **datasets):
    import h5py

    if not is_writer():
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with h5py.File(path, "w") as f:
        for k, v in datasets.items():
            f.create_dataset(k, data=np.asarray(v))


def _read_h5(path, name):
    import h5py

    with h5py.File(path, "r") as f:
        return f[name][...]


def write_field_per_lambda(files: OutputFiles, kind: str, arr, ind=None):
    """Write a (ncell|nsid, L) or (nsid, ndir, L) array as per-lambda files.

    kind: 'u_fest_part1' | 'ufield' | 'ufield_part2' | 'i_obs' | ... matching
    the OutputFiles accessors; dataset name inside the file = kind.
    """
    arr = np.asarray(arr)
    L = arr.shape[-1]
    ind = range(L) if ind is None else ind
    for il in ind:
        _write_h5(getattr(files, kind)(il), **{kind: arr[..., il]})


def read_field_per_lambda(files: OutputFiles, kind: str, shape_head, ind=None):
    L = len(files.lambda_um)
    ind = list(range(L)) if ind is None else list(ind)
    out = np.zeros(tuple(shape_head) + (L,))
    for il in ind:
        out[..., il] = _read_h5(getattr(files, kind)(il), kind)
    return out


def write_sed(files: OutputFiles, sed, part2=False):
    _write_h5(files.sed_dir if part2 else files.sed, sed=np.asarray(sed),
              lambda_um=files.lambda_um)


def write_lum_lost(files: OutputFiles, lum_lost, tot_rad_en, part2=False):
    """Lost-luminosity fractions per wavelength (print_lum_lost
    io_routines.f90:2191): > 1% triggers a warning in the reference."""
    frac = np.where(np.asarray(tot_rad_en) > 0,
                    np.asarray(lum_lost) / np.maximum(tot_rad_en, 1e-300), 0.0)
    _write_h5(files.lum_lost_part2 if part2 else files.lum_lost,
              lum_lost=np.asarray(lum_lost), fraction=frac,
              lambda_um=files.lambda_um)


def write_maps(files: OutputFiles, maps_arr, lambda_maps, internal=False):
    _write_h5(files.maps_in if internal else files.maps,
              maps=np.asarray(maps_arr), lambda_um=np.asarray(lambda_maps))


def write_scaspe(files: OutputFiles, scfg, scaspe: tuple, kind="scaspe_part2"):
    """Persist the per-bucket scattering source function as per-wavelength
    files, dataset (ncell, npix_tot) like the reference's scaspe outputs
    (make_output io_routines.f90:1743; print_big_array :1112)."""
    for b, s in zip(scfg.buckets, scaspe):
        s = np.asarray(s)
        for j, il in enumerate(b.lam_idx):
            _write_h5(getattr(files, kind)(int(il)), scaspe=s[:, :, j])


def read_scaspe(files: OutputFiles, scfg, ncell: int, kind="scaspe_part2"):
    """Inverse of write_scaspe (read_output, io_routines.f90:1900-1997).

    Files saved with more appended observer columns than the current scfg
    expects are sliced down (the i_obs recompute algorithm reads scaspe_tot
    with new observer directions; only the HEALPix pixels are reused,
    rt_routines.f90:3043)."""
    out = []
    for b in scfg.buckets:
        arr = np.zeros((ncell, b.npix_tot, len(b.lam_idx)))
        for j, il in enumerate(b.lam_idx):
            a = _read_h5(getattr(files, kind)(int(il)), "scaspe")
            if a.shape[1] < b.npix_tot:
                raise ValueError(
                    f"saved scaspe has {a.shape[1]} direction columns, "
                    f"current config needs {b.npix_tot}"
                )
            arr[:, :, j] = a[:, : b.npix_tot]
        out.append(arr)
    return tuple(out)


def write_file_info(files: OutputFiles, cfg, extra: dict = None):
    """Run-parameter dump (write_file_info, io_routines.f90:854-890):
    human-readable key=value list of the input namelist + run info."""
    import dataclasses as _dc

    if not is_writer():
        return
    os.makedirs(files.dir_runs, exist_ok=True)
    with open(files.info, "w") as f:
        f.write("# dartray_tpu run info\n")
        for field in _dc.fields(cfg):
            f.write(f"{field.name} = {getattr(cfg, field.name)!r}\n")
        for k, v in (extra or {}).items():
            f.write(f"{k} = {v!r}\n")


def write_psel_av(files: OutputFiles, stats: dict, lambda_um):
    """Ray/path telemetry (psel_av_arr / ipsel_av_tot,
    rt_routines.f90:72-74, 3220): per-stage ray and intersection counters
    and the mean intersections per ray."""
    keys = sorted(k for k in stats if k.endswith("_rays") or k.endswith("_steps"))
    data = {k: np.asarray(stats[k]) for k in keys}
    rays = sum(v for k, v in data.items() if k.endswith("_rays"))
    steps = sum(v for k, v in data.items() if k.endswith("_steps"))
    data["psel_av"] = np.asarray(steps / max(rays, 1), dtype=np.float64)
    data["ipsel_av_tot"] = np.asarray(rays)
    _write_h5(os.path.join(files.dir_runs,
                           f"grid_{files.label}_psel_av{files.chext}.h5"),
              **data)


def check_memory(grid_ncell: int, L: int, scfg=None, n_dir: int = 0,
                 safety: float = 1.2) -> dict:
    """Pre-flight memory estimate (check_memory, io_routines.f90:3540-3607):
    scaspe + field bytes vs available memory.  The arrays live on the
    device, so on an accelerator the bound is the device's own
    ``memory_stats`` and exceeding it raises MemoryError.  Only on the CPU
    backend does host /proc/meminfo stand in, and then an overrun only
    warns."""
    import jax

    field_b = 3 * grid_ncell * L * 8  # u_fest, u_final, delta
    scaspe_b = scfg.nbytes(grid_ncell) * 2 if scfg is not None else 0
    iobs_b = grid_ncell * max(n_dir, 1) * L * 8
    need = int((field_b + scaspe_b + iobs_b) * safety)
    dev = jax.local_devices()[0]
    on_device = dev.platform != "cpu"
    avail = None
    if on_device:
        ms = dev.memory_stats()
        if not ms or not ms.get("bytes_limit"):
            raise RuntimeError(
                f"{dev.platform} device reports no memory_stats (check_memory)")
        avail = ms["bytes_limit"] - ms.get("bytes_in_use", 0)
    else:
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemAvailable"):
                        avail = int(line.split()[1]) * 1024
                        break
        except OSError:
            pass
    est = dict(field_bytes=field_b, scaspe_bytes=scaspe_b, iobs_bytes=iobs_b,
               total_bytes=need, available_bytes=avail)
    if avail is not None and need > avail:
        msg = (f"projected memory {need/2**30:.1f} GiB exceeds available "
               f"{avail/2**30:.1f} GiB (check_memory)")
        if on_device:
            raise MemoryError(msg)
        import warnings

        warnings.warn(msg + " [host-RAM proxy on the CPU backend]")
    return est


def check_files(files: OutputFiles, need_in: bool = False) -> str:
    """Stage-level restart detection (check_files, io_routines.f90:893):
    returns 'part2' if all direct-light outputs (incl. scaspe) exist,
    'part1' if the precalc output exists, else ''."""
    L = len(files.lambda_um)
    part2 = all(
        os.path.exists(files.ufield_part2(il)) and os.path.exists(files.scaspe_part2(il))
        for il in range(L)
    )
    if part2:
        return "part2"
    part1 = all(os.path.exists(files.u_fest_part1(il)) for il in range(L))
    return "part1" if part1 else ""
