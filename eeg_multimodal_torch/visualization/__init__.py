"""Figures from run records and checkpoints (the JAX package's visualization/)."""
