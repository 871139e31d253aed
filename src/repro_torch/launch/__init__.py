"""Entry points (port): layout planning and LM serving."""
