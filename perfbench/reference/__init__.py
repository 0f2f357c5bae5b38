"""Plain PyTorch / NumPy references, one module a configuration family.
They import nothing of the port, of JAX or of the JAX package."""
