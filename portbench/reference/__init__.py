"""The plain reference: plain NumPy and PyTorch, nothing of the program."""
