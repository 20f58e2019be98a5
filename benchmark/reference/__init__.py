"""The plain reference the benchmark judges the port's outputs against. It
imports nothing of the port and nothing of the JAX package."""
