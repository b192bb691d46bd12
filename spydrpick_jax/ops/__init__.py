from spydrpick_jax.ops.mi import mi_from_crosstabs, make_tile_mi_fn

__all__ = ["mi_from_crosstabs", "make_tile_mi_fn"]
