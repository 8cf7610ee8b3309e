"""Logging, device choice and the JAX weight carry-over."""
