"""Layout planning (port)."""
