"""What the program needs from its environment: the compile-cache placement,
the precision of the DFT matmuls, and a main path free of h5py."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
from jax import lax

from smoqyelphqmc_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_env_variable_wins(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    try:
        got = compile_cache.enable_compile_cache()
        assert got == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _dot_precisions(jaxpr):
    """precision of every dot_general in a jaxpr, sub-jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                if hasattr(sub, "jaxpr"):
                    out += _dot_precisions(sub.jaxpr)
                elif hasattr(sub, "eqns"):
                    out += _dot_precisions(sub)
    return out


def _transforms():
    from smoqyelphqmc_tpu.measure.greens_estimator import build_greens_estimator
    from smoqyelphqmc_tpu.ops.fourier import AxisDFT, FactoredDFT, PackedDFT, TauFourier

    x = jnp.ones((3, 12, 5), jnp.float32)
    tf = TauFourier.build(12, dtype="float32")
    est = build_greens_estimator(6, 1, (2, 2), Nrv=2, dtype="float32")
    a = jnp.ones((2, 12, 2, 2), jnp.float32)  # doubled tau axis: 2 Ltau
    return {
        "TauFourier.forward": lambda: tf.forward(x, x),
        "TauFourier.inverse": lambda: tf.inverse(x, x),
        "FactoredDFT": lambda: FactoredDFT.build(12, dtype="float32").apply(x, x, axis=-2),
        "PackedDFT": lambda: PackedDFT.build(12, dtype="float32").apply(x, x, axis=-2),
        "AxisDFT": lambda: AxisDFT.build(12, dtype="float32").apply(x, x, axis=-2),
        "estimator xcorr": lambda: est.xcorr_accumulate(a, a, a, a, doubled=True),
    }


@pytest.mark.parametrize("name", list(_transforms()))
def test_f32_dft_matmuls_ask_for_highest(name):
    """At the default precision an f32 matmul may run in TF32 on a GPU; every
    DFT matmul feeding forces and observables asks for HIGHEST."""
    precs = _dot_precisions(jax.make_jaxpr(_transforms()[name])().jaxpr)
    assert precs, "no dot_general traced"
    highest = (lax.Precision.HIGHEST, lax.Precision.HIGHEST)
    assert all(p == highest for p in precs), precs


def test_driver_runs_without_h5py(tmp_path):
    """The main path (driver import, bin writes, merge and statistics) runs
    with h5py unimportable: the package depends only on JAX, NumPy, SciPy
    and the standard library."""
    code = f"""
import sys
sys.modules["h5py"] = None
sys.path.insert(0, {REPO!r})
sys.path.insert(0, {os.path.join(REPO, "tests")!r})
import numpy as np
import smoqyelphqmc_tpu.driver
from smoqyelphqmc_tpu.io import SimulationInfo, initialize_datafolder, merge_bins, process_measurements, write_measurement_bin, archive
from smoqyelphqmc_tpu.measure.container import MeasurementSpec
from _models import chain_model
spec = MeasurementSpec(geometry=chain_model(L=4)[0])
spec.add_correlation("density", [(0, 0)], integrated=True)
sim = SimulationInfo(filepath={str(tmp_path)!r}, datafolder_prefix="noh5", sID=1)
initialize_datafolder(sim)
for b in range(2):
    c = np.full((1, 3, 4), float(b))
    write_measurement_bin(sim, b, {{"global": {{"density": (np.asarray(1.0 + b), np.asarray(0.0))}},
        "correlations": {{"density": (c, np.zeros_like(c))}}}}, spec, dtau=0.1)
merge_bins(sim)
stats = process_measurements(sim.datafolder, spec=spec)
assert abs(archive.load(stats)["global/density/mean"] - 1.5) < 1e-12
assert "h5py" not in [m for m in sys.modules if sys.modules[m] is not None]
print("ok")
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
