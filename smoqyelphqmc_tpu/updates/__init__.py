from .context import QMCContext, QMCState, make_fdm, initialize_qmc
from .hmc import HMCParams, hmc_update
from .global_updates import reflection_update, swap_update, radial_update
from .mu_tuner import MuTunerState, init_mu_tuner, update_chemical_potential

__all__ = [
    "QMCContext",
    "QMCState",
    "make_fdm",
    "initialize_qmc",
    "HMCParams",
    "hmc_update",
    "reflection_update",
    "swap_update",
    "radial_update",
    "MuTunerState",
    "init_mu_tuner",
    "update_chemical_potential",
]
