"""LM serving of the port (twin of ``repro.serving``)."""
