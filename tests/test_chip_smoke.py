"""The smoke run's phases (chip_smoke.py) at a tiny size, and the parts of
running on a GPU that the CPU can check: the device check, the compile
cache, matmul precision, imports without h5py, one card per process and
the device-memory preflight."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import chip_smoke as CS
from dartray_tpu import runtime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAM = [0.1, 0.4, 1.0, 10.0]  # L = 4 stellar wavelengths
MAX_LVL = 2


@pytest.fixture(scope="module")
def tiny():
    prob = CS.setup(max_lvl=MAX_LVL, lam=LAM)
    direct, scfg = CS.phase_direct(prob, runs=1, memory=True)
    return prob, direct, scfg


def test_direct_phase(tiny):
    prob, direct, scfg = tiny
    L = prob.wl.lnum_stars
    assert L == len(LAM)
    for stage in ("precalc", "direct"):
        assert direct.stats[f"{stage}_wall_s"] > 0
        assert np.shape(direct.stats[f"{stage}_lum_esc"]) == (L,)


def test_single_scattering_phase():
    CS.phase_single_scattering(max_lvl=MAX_LVL, lam=LAM, runs=1)


def test_scattering_phase(tiny):
    prob, direct, scfg = tiny
    sres = CS.phase_scattering(prob, direct, scfg, every=3, runs=1)
    assert sres.stats["scatt_rays"] > 0


def test_gradient_phase(tiny):
    prob, direct, scfg = tiny
    CS.phase_gradient(prob, direct, scfg, n_sources=512, runs=1)


def test_sto_phase():
    CS.phase_sto(runs=1)


def test_meshes_match_one_device(tiny):
    """The --four mesh path on 4 virtual CPU devices."""
    prob, _, _ = tiny
    out = CS.mesh_runs(prob, every=7, devices=jax.devices()[:4])
    for name in ("rays4", "rays2_wave2"):
        CS.compare_runs(name, out["one_card"], out[name])


@pytest.mark.gpu
def test_phases_on_card(gpu_device):
    prob = CS.setup(max_lvl=MAX_LVL, lam=LAM)
    direct, scfg = CS.phase_direct(prob, runs=1, memory=True)
    CS.phase_single_scattering(max_lvl=MAX_LVL, lam=LAM, runs=1)
    CS.phase_scattering(prob, direct, scfg, every=3, runs=1)
    CS.phase_gradient(prob, direct, scfg, n_sources=512, runs=1)
    CS.phase_sto(runs=1)


def test_device_check_refuses_cpu():
    if jax.devices()[0].platform == "gpu":
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_gpu()


@pytest.mark.parametrize("alone", [False, True],
                         ids=["in_checkout", "script_alone"])
def test_smoke_without_gpu_exits_nonzero(tmp_path, alone):
    """No GPU, or no package beside the script: non-zero exit and no
    result line."""
    if alone:
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    else:
        script, cwd = os.path.join(ROOT, "chip_smoke.py"), ROOT
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_ENABLE_COMPILATION_CACHE="false")
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert runtime.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_ignored_path_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = runtime.setup_compile_cache()
        assert path == runtime.DEFAULT_CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert os.path.dirname(path) == ROOT
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert os.path.basename(path) + "/" in f.read().split()


def _dot_precisions(jaxpr):
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for sub in jax.core.jaxprs_in_params(eqn.params):
            out.extend(_dot_precisions(sub))
    return out


def _all_highest(closed):
    precs = _dot_precisions(closed.jaxpr)
    assert precs, "no matrix product traced"
    hi = jax.lax.Precision.HIGHEST
    return all(p is not None and all(x == hi for x in p) for p in precs)


def test_matmul_precision_is_highest():
    """No float32 product on these paths may run in TF32 on a GPU."""
    from dartray_tpu import dust_emission as DE
    from dartray_tpu.rt import replay as REP

    nr, P, Lk = 5, 14, 3
    hg = jax.make_jaxpr(lambda t, p, g, d: REP.hg_ffn(t, p, g, d, 12))(
        jnp.zeros(nr), jnp.zeros(nr), jnp.full(Lk, 0.6), jnp.ones((P, 3)))
    assert _all_highest(hg)
    C, A, Ls, Ld, n = 2, 3, 4, 5, 6
    ab = jax.make_jaxpr(DE.grain_absorbed)(
        jnp.ones((C, A, Ls)), jnp.ones((n, Ls)), jnp.ones(Ls),
        jnp.ones((C, A, Ld)), jnp.ones((n, Ld)), jnp.ones(Ld))
    assert _all_highest(ab)
    em = jax.make_jaxpr(DE.grain_emission)(
        jnp.ones((n, C, A, Ld)), jnp.ones((C, A, Ld)), jnp.ones((C, A)))
    assert _all_highest(em)


def test_device_path_imports_without_h5py():
    code = (
        "import sys; sys.modules['h5py'] = None\n"
        "import dartray_tpu.pipeline, dartray_tpu.rt.engine, "
        "dartray_tpu.rt.scattering, dartray_tpu.rt.replay, "
        "dartray_tpu.grid.octree, dartray_tpu.parallel.mesh, "
        "dartray_tpu.parallel.distributed, dartray_tpu.sto, chip_smoke\n"
        "try:\n"
        "    import h5py\n"
        "except ImportError:\n"
        "    print('blocked')\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "blocked"


@pytest.mark.parametrize("coordinator,pid,expect", [
    ("localhost:1234", 2, [2]),
    ("127.0.0.1:99", 0, [0]),
    ("10.0.0.7:1234", 1, None),
    ("node-3:4000", 3, None),
    (None, None, None),
])
def test_local_device_ids(coordinator, pid, expect):
    from dartray_tpu.parallel import distributed as DIST

    assert DIST.local_device_ids(coordinator, pid) == expect


class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform = platform
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_check_memory_uses_device_stats_on_gpu(monkeypatch):
    from dartray_tpu import io_output as OUT

    gib = 2**30
    monkeypatch.setattr(jax, "local_devices", lambda: [
        _FakeDevice("gpu", {"bytes_limit": 80 * gib, "bytes_in_use": gib})])
    est = OUT.check_memory(1000, 4)
    assert est["available_bytes"] == 79 * gib
    with pytest.raises(MemoryError):
        OUT.check_memory(10**9, 32)
    monkeypatch.setattr(jax, "local_devices",
                        lambda: [_FakeDevice("gpu", None)])
    with pytest.raises(RuntimeError, match="memory_stats"):
        OUT.check_memory(1000, 4)


def test_check_memory_host_proxy_on_cpu(monkeypatch):
    from dartray_tpu import io_output as OUT

    monkeypatch.setattr(jax, "local_devices",
                        lambda: [_FakeDevice("cpu", None)])
    est = OUT.check_memory(1000, 4)
    assert est["available_bytes"] is None or est["available_bytes"] > 0
    with pytest.warns(UserWarning, match="host-RAM proxy"):
        OUT.check_memory(10**11, 32)
