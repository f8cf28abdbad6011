"""Weights carried across from the JAX parameter tree."""
