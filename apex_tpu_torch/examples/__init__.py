"""Runnable examples of the port (the JAX package's ``examples/`` belong
to it; these live inside the port's package)."""
