"""smoqyelphqmc_tpu — accelerator-native electron-phonon determinant QMC framework.

A from-scratch JAX/XLA re-design of the capabilities of
SmoQySuite/SmoQyElPhQMC.jl (reference layout: /root/reference/src/SmoQyElPhQMC.jl):
near-linear-scaling quantum Monte Carlo for spin-symmetric electron-phonon models
(Holstein + SSH couplings), built for one GPU or several:

- the fermion determinant matrix M is applied matrix-free via checkerboard-factorized
  propagators expressed as per-color gather + elementwise kernels over (Ltau, N)
  space-time blocks (no scatter in the hot path);
- the pseudofermion action and forces are evaluated with a *batched* preconditioned
  conjugate-gradient solver (`lax.while_loop` with per-RHS convergence masking);
- CG is preconditioned by a KPM/Chebyshev expansion applied per Matsubara frequency
  after a batched FFT along imaginary time, with frequencies statically bucketed by
  expansion order so one Chebyshev recurrence serves a whole frequency block;
- phonon fields are sampled with exact-Fourier-accelerated pseudofermion HMC plus
  reflection / swap / radial global updates, all as pure jitted functions of a state
  pytree (no mutation, rejection = `jnp.where` select);
- observables are estimated stochastically from batched random-vector solves, with
  translational averaging via batched space-time FFT cross-correlation;
- many-walker parallelism is a vmapped walker axis sharded over a `jax.sharding.Mesh`
  (replacing the reference's MPI layer).

Everything runs in float64/complex128 by default (CG tolerances of 1e-10 and
Metropolis accept/reject are not float32-safe).
"""

import jax

jax.config.update("jax_enable_x64", True)

from .lattice import UnitCell, Lattice, Bond, ModelGeometry  # noqa: E402
from .models.tight_binding import TightBindingModel, TightBindingParameters  # noqa: E402
from .models.electron_phonon import (  # noqa: E402
    PhononMode,
    HolsteinCoupling,
    SSHCoupling,
    DispersionCoupling,
    ElectronPhononModel,
    ElectronPhononParameters,
)
from .models.fermion_path_integral import FermionPathIntegral, build_path_integral  # noqa: E402
from .ops.fermion_det import FermionDetMatrix  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "UnitCell",
    "Lattice",
    "Bond",
    "ModelGeometry",
    "TightBindingModel",
    "TightBindingParameters",
    "PhononMode",
    "HolsteinCoupling",
    "SSHCoupling",
    "DispersionCoupling",
    "ElectronPhononModel",
    "ElectronPhononParameters",
    "FermionPathIntegral",
    "build_path_integral",
    "FermionDetMatrix",
]
