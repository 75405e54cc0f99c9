"""Operator services of the port (the engine half of the JAX package's
``services/``): ``diagnostics_service`` reads a live engine's state and
captures a ``torch.profiler`` trace of it."""
