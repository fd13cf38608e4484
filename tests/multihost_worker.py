"""Worker for tests/test_multihost.py: one of two cooperating processes
(2 x 4 virtual CPU devices) running multi-process RT (P8, initialize_mpi
io_routines.f90:3610-3656).

Modes:
  stage     — one sharded field-stage march over the 8-device GLOBAL mesh
              (the global-array path, sharded_march_u).
  pipeline  — the production path: pipeline.run_main (precalc + direct +
              scattering iterations, blocking/merges ON, lambda-sharded
              scaspe on a local (rays=2, wave=2) mesh) with rank-strided
              sources + per-stage cross-process reductions
              (engine.run_field_stage P8).

Usage: python multihost_worker.py <port> <process_id> <out.npz> [mode]
"""
import os
import sys

port, pid, out_path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
mode = sys.argv[4] if len(sys.argv) > 4 else "stage"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4"
)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

# the CPU backend with 4 virtual devices (XLA_FLAGS above), whatever
# accelerator the machine has
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from dartray_tpu.parallel import distributed as DIST

DIST.initialize(f"localhost:{port}", 2, pid)
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 8, jax.device_count()

import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from dartray_tpu.models import trustI
from dartray_tpu.rt import engine as E, march as M, rays as R
from dartray_tpu.parallel import mesh as PM


def run_stage():
    grid = trustI.build_trustI_grid(
        tau_z=1.0, base=(6, 2), max_lvl=2, min_lvl=1, max_ncell=100_000
    )
    L = 2
    kext_norm = np.array([2.0, 1.0])
    albedo = np.zeros(L)
    psrc = E.point_source_set(grid, trustI.STAR_POS[None, :], np.ones((1, L)))
    launch = R.fresh_launch(psrc.pos, psrc.cell, np.array([0]), psrc.lum)
    NRAYS = len(launch["src_cell"])
    pad = -NRAYS % 8
    batch_host, beam_host, _ = R._to_batch(launch, L, pad_to=NRAYS + pad)

    mesh = DIST.global_ray_mesh()
    assert mesh.shape["rays"] == 8

    # global sharded batch: every process holds identical host data and
    # feeds the shards its local devices own
    import dataclasses

    specs = PM._BATCH_SPECS
    batch = M.RayBatch(**{
        f.name: DIST.host_local_batch(
            mesh, getattr(specs, f.name),
            np.asarray(getattr(batch_host, f.name)),
        )
        for f in dataclasses.fields(M.RayBatch)
    })

    u, lost = PM.sharded_march_u(
        mesh, grid, jnp.asarray(np.asarray(grid.dens_ref)),
        jnp.asarray(kext_norm), jnp.asarray(albedo), batch,
        beam_i=float(4 * np.pi / (12 * 16)),  # nside=4, scalar: replicable
        mode=M.MODE_PRECALC, point_source=True, rad_lim_dist=1e9,
        bm_par=1e9, bm_par_max=1e12, allow_block=False, cs=1.0,
        max_steps=10000,
    )
    # the psum result is replicated: every process can read it whole
    np.savez(out_path, u=np.asarray(u), lost=np.asarray(lost))


def run_pipeline():
    """The full production pipeline across 2 processes: run_main with
    blocking/merges ON, one+ scattering iteration, and the scaspe lambda
    axis sharded over a local (rays=2, wave=2) mesh in each process."""
    from dartray_tpu import pipeline as PIPE
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
    mesh = PM.make_mesh(2, 2, devices=jax.local_devices())
    res = PIPE.run_main(
        grid, cfg, wl, dust,
        dens_stars_arr=None, p_src_pos=trustI.STAR_POS[None, :],
        p_src_lum=np.ones((1, L)), dir_out=np.array([[0.0, 0.0]]),
        chunk=8, mesh=mesh,
    )
    np.savez(
        out_path, u=np.asarray(res.u_final), i_obs=np.asarray(res.i_obs),
        iterations=res.iterations,
    )


if mode == "stage":
    run_stage()
else:
    run_pipeline()
print(f"# process {pid}: ok ({mode})", flush=True)
