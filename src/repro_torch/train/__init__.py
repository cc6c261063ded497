"""Training runtime: the event simulator, its batched engine, elasticity."""
