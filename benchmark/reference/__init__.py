"""The plain float32 reference: PyTorch and NumPy only, nothing of the
measured program."""
