"""Serving: the public scheduling API and the placement daemon (port)."""
