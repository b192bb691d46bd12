from spydrpick_jax.utils.stopwatch import Stopwatch
from spydrpick_jax.utils.uniquefile import unique_path

__all__ = ["Stopwatch", "unique_path"]
