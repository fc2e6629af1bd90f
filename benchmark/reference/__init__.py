"""Plain references that decide ``correct``: plain PyTorch, importing
nothing of the program under test."""
