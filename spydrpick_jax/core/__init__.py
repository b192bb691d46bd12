from spydrpick_jax.core.alphabet import N_STATES, GAP_STATE
from spydrpick_jax.core.alignment import Alignment

__all__ = ["N_STATES", "GAP_STATE", "Alignment"]
