from spydrpick_jax.engine.solver import EngineConfig, MIEngine, EdgeSet

__all__ = ["EngineConfig", "MIEngine", "EdgeSet"]
