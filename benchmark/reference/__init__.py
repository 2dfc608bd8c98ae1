"""Plain PyTorch references, one module a model family; nothing here imports the program."""
