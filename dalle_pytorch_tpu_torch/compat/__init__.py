"""Bridges from the JAX package's parameter trees."""
