"""The plain reference: PyTorch arithmetic that imports nothing of the program."""
