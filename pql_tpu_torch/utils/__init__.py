"""Utilities of the port: episode trackers and state conversion from the JAX package."""
