"""Command-line entry points of the port (twin of ``repro.launch``): serving,
training, the sharded replay, and the meshes over a process group."""
