"""Plain PyTorch and NumPy references of what the cells time.  Nothing here
imports the port, JAX or the JAX package: the references take the
benchmark's own inputs and weights and work out what the port derives."""
