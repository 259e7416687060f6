"""The package version ``/version`` reports (the JAX package's)."""

__version__ = "0.1.0"
