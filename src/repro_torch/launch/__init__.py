"""Entry points (port): layout planning, LM serving and training, and
the dry run for one card."""
