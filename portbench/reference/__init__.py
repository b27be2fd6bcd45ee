"""The plain PyTorch references the benchmark holds the program to."""
