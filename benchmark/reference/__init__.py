"""The plain reference: NumPy and plain PyTorch in f64, importing
nothing of the program or of JAX."""
