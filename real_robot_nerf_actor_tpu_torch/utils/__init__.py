"""Config loading (the port's copy of the JAX package's utils/config.py)."""
