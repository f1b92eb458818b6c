"""Entry points of the program, one to a file, found by name."""
