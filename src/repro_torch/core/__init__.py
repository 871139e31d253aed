"""Cluster types, environment, Q-net and scheduling dispatch (port)."""
