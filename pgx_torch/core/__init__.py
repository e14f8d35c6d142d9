"""Equalized-learning-rate layer primitives of the port."""
