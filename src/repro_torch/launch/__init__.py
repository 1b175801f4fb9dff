"""Command-line entry points of the port's model paths (twin of ``repro.launch``)."""
