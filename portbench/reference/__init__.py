"""The plain references the benchmark holds the port to: plain PyTorch
and NumPy, importing nothing of the port."""
