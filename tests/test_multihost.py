"""Multi-host execution (P8): two cooperating processes, 4 virtual CPU
devices each, march one sharded field stage over the 8-device global mesh
and must agree with the single-process result.

The analog of the reference's MPI environment (initialize_mpi
io_routines.f90:3610-3656): every process runs the same program;
jax.distributed connects them (parallel/distributed.py).
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "multihost_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(tmp_path, mode):
    port = _free_port()
    outs = [tmp_path / f"{mode}_p{i}.npz" for i in range(2)]
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count (4)
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(port), str(i), str(outs[i]), mode],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    logs = []
    for p in procs:
        out, _ = p.communicate(timeout=900)
        logs.append(out.decode())
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return outs


def test_two_process_field_stage(tmp_path):
    outs = _run_workers(tmp_path, "stage")

    # single-process reference (this test process: 8 virtual devices)
    import jax.numpy as jnp
    from dartray_tpu.models import trustI
    from dartray_tpu.rt import engine as E, march as M, rays as R

    grid = trustI.build_trustI_grid(
        tau_z=1.0, base=(6, 2), max_lvl=2, min_lvl=1, max_ncell=100_000
    )
    L = 2
    psrc = E.point_source_set(grid, trustI.STAR_POS[None, :], np.ones((1, L)))
    launch = R.fresh_launch(psrc.pos, psrc.cell, np.array([0]), psrc.lum)
    n = len(launch["src_cell"])
    batch, _, _ = R._to_batch(launch, L, pad_to=n + (-n % 8))
    u0 = jnp.zeros((grid.n_cells, L))
    u_ref, _ = M.march(
        grid, jnp.asarray(np.asarray(grid.dens_ref)),
        jnp.asarray(np.array([2.0, 1.0])), jnp.zeros(L), u0, u0, batch,
        beam_i=float(4 * np.pi / (12 * 16)),
        mode=M.MODE_PRECALC, point_source=True, rad_lim_dist=1e9,
        bm_par=1e9, bm_par_max=1e12, allow_block=False, cs=1.0,
        max_steps=10000,
    )
    u_ref = np.asarray(u_ref)

    for o in outs:
        d = np.load(o)
        np.testing.assert_allclose(
            d["u"], u_ref, rtol=1e-10, atol=u_ref.max() * 1e-13
        )
    # both processes computed the identical replicated result
    np.testing.assert_array_equal(np.load(outs[0])["u"], np.load(outs[1])["u"])


def test_two_process_full_pipeline(tmp_path):
    """The FULL production pipeline across 2 processes (verdict r4 #6):
    pipeline.run_main with blocking/merges ON, scattering iterations, and
    a lambda-sharded scaspe on each process's local (rays=2, wave=2)
    mesh; rank-strided sources + per-stage reductions (P8) must
    reproduce the single-process result."""
    outs = _run_workers(tmp_path, "pipeline")

    # single-process reference: same workload, no mesh
    import numpy as np
    import jax
    from dartray_tpu import pipeline as PIPE
    from dartray_tpu.models import trustI
    from dartray_tpu.config import RTConfig
    from dartray_tpu.wavelength import make_wavelength_grid
    from dartray_tpu.dust import DustModel

    grid = trustI.build_trustI_grid(
        tau_z=1.0, base=(10, 2), max_lvl=2, min_lvl=1, max_ncell=100_000
    )
    L = 4
    lam = np.array([0.3, 0.5, 1.0, 2.0])
    wl = make_wavelength_grid(lam, max_lambda_stars=30.0, min_lambda_dust=1.0)
    dust = DustModel(
        lambda_um=lam, kabs=np.full(L, 0.6), ksca=np.full(L, 0.4),
        kext=np.asarray(np.linspace(2.0, 0.5, L)),
        gsca=np.array([0.6, 0.4, 0.2, 0.0]), kext_ref=1.0,
    )
    cfg = RTConfig(
        accuracy=0.3, bm_par=3, bm_par_sca=2, bm_par_max=30,
        conv_en_lim=0.05, kp_sca_max=1, use_p_src=True,
    ).validate()
    res = PIPE.run_main(
        grid, cfg, wl, dust,
        dens_stars_arr=None, p_src_pos=trustI.STAR_POS[None, :],
        p_src_lum=np.ones((1, L)), dir_out=np.array([[0.0, 0.0]]),
        chunk=8,
    )
    u_ref = np.asarray(res.u_final)
    for o in outs:
        d = np.load(o)
        assert int(d["iterations"]) == res.iterations
        np.testing.assert_allclose(
            d["u"], u_ref, rtol=1e-8, atol=u_ref.max() * 1e-11
        )
        np.testing.assert_allclose(
            d["i_obs"], res.i_obs, rtol=1e-8, atol=np.max(res.i_obs) * 1e-11
        )
    # deterministic lockstep: both processes hold identical reduced fields
    np.testing.assert_array_equal(np.load(outs[0])["u"], np.load(outs[1])["u"])


def test_cli_multihost_smoke(tmp_path):
    """The CLI --multihost entry end to end: 2 processes run the SAME
    `run` command (DARTRAY_MULTIHOST=1 + coordination env vars); process 0
    writes the outputs, process 1 writes nothing, both exit 0."""
    import numpy as np

    DATA = os.path.join(ROOT, "data")
    d = tmp_path
    lam = [0.5, 1.0]
    (d / "lambda_small.dat").write_text("\n".join(str(x) for x in lam) + "\n")
    (d / "dir_out.dat").write_text(" THETA PHI\n0.0 0.0\n")
    (d / "pos_point_sources.dat").write_text(" X Y Z\n0. 0. 0.\n")
    (d / "param_point_sources.dat").write_text(" Teff Lbol\n3660 112201.89\n")
    common = f"""
&magtar_input_strings
grid_file='grid_shell.h5'
dir_grid='{d}/'
dust_geometry = 'shell'
file_lambda_list = 'lambda_small.dat',
units_lambda = 'um',
dust_model = 'TRUST',
file_av_opacities = '{DATA}/DUST_OPACITY/TRUST/ZDA_BARE_GR_S_Effective.dat'
subdivision_criteria = 'shell'
/
&magtar_input_var
modelsize =10
tau_z=4.8E-1
lambda_ref=1.
base=6,2
ax=1.09
by=2.18
cz=2.18
elrad_width=0.10
max_ncell=1.5E6
max_lvl=2
min_lvl=1.
max_dtau=4.8E-1
/
&magtar_input_logical
input_av_opacities = .TRUE.,
/"""
    (d / "input_grid_shell.in").write_text(common)
    (d / "input_shell.in").write_text(f"""
&dartray_input_strings
label_model_out = 'shell_mh'
grid_file='grid_shell.h5',
file_dir_out='dir_out.dat',
file_p_src='pos_point_sources.dat',
file_lambda_list='lambda_small.dat',
dir_runs='{d}/RUNS',
rt_algorithm = 'main',
dir_grid='{d}/',
units_lambda = 'um',
dust_model = 'TRUST',
file_av_opacities = '{DATA}/DUST_OPACITY/TRUST/ZDA_BARE_GR_S_Effective.dat',
units_csize = 'pc',
units_luminosity = 'erg/s/Hz',
dust_heating_type = 'eff',
file_param_src = 'param_point_sources.dat'
/
&dartray_input_var
lambda_ref = 1.,
kp_sca_max=0,
rad_lim=0.2,
accuracy=0.3,
conv_en_lim=0.05,
bm_par = 3,
bm_par_sca= 2,
bm_par_max=30,
max_lambda_stars = 30,
min_lambda_dust = 1.,
dist_obs = 10E3
/
&dartray_input_logical
use_dir_out = .TRUE.,
use_p_src = .TRUE.,
print_sed = .TRUE.,
input_av_opacities = .TRUE.,
no_dust_rt = .TRUE.,
only_direct_rt = .FALSE.
/""")

    # grid creation: in-process, single process
    from dartray_tpu import cli

    rc = cli.main(["create-grid", "magtar", str(d / "input_grid_shell.in")])
    assert rc == 0

    port = _free_port()
    env_base = dict(os.environ)
    env_base.pop("XLA_FLAGS", None)
    env_base.update(
        JAX_PLATFORMS="cpu",
        JAX_ENABLE_COMPILATION_CACHE="false",  # keep the checkout clean
        XLA_FLAGS="--xla_force_host_platform_device_count=2",
        DARTRAY_MULTIHOST="1",
        DARTRAY_COORDINATOR=f"localhost:{port}",
        DARTRAY_NUM_PROCS="2",
    )
    procs = []
    for i in range(2):
        env = dict(env_base, DARTRAY_PROC_ID=str(i))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dartray_tpu.cli", "run", "magtar",
             str(d / "input_shell.in")],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        ))
    logs = []
    for p in procs:
        out, _ = p.communicate(timeout=900)
        logs.append(out.decode())
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    assert "multihost: process" in logs[0] + logs[1]
    runs = d / "RUNS"
    assert (runs / "grid_shell_mh_sed.h5").exists()
    import h5py

    with h5py.File(runs / "grid_shell_mh_sed.h5") as f:
        sed = f["sed"][...]
    assert np.all(sed > 0)
