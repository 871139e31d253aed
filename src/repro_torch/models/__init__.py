"""The LM (port of ``repro.models``): layers and the dense / vlm model."""
