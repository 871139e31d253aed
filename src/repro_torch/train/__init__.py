"""Multi-candidate training (port of ``repro.train``)."""
