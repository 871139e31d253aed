"""Arrival streams for the serving daemon (port)."""
from repro_torch.scenarios.arrivals import ArrivalTrace, arrival_trace, trace_from_table

__all__ = ["ArrivalTrace", "arrival_trace", "trace_from_table"]
