"""Scale-out paths: the bundle adjustment sharded over a mesh of devices."""
