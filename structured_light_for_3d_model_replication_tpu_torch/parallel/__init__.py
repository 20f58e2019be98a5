"""Device-mesh layer: data parallel over scans, space parallel over image
rows (counterpart of the JAX package's ``parallel/``)."""

from . import distributed, mesh, pipeline  # noqa: F401
