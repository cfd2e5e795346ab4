"""Command-line tools of the port (counterparts of the repository's
tools/ that run without JAX)."""
