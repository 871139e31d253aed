"""Batched evaluation (port of ``repro.eval``)."""
