"""The plain reference that decides `correct`: NumPy and plain PyTorch
only. It imports nothing of the program and nothing of JAX, and it is
handed bases the benchmark made itself and the program's answers to
judge."""
