"""Device meshes of the port (``mesh.Mesh``)."""
