"""The plain reference the benchmark judges the program's outputs by:
numpy and PyTorch, nothing of the program under test."""
