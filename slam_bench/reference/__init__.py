"""Plain PyTorch references of what the timed path computes. They import
neither the program nor JAX."""
