"""The device mesh of the port (parallel/mesh.py) and the launcher that starts
one process per rank (parallel/launch.py)."""
