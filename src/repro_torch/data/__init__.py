"""Host-side data for the port's model paths (twin of ``repro.data``)."""
