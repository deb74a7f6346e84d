"""Device meshes of the port (``launch/mesh.py``)."""
