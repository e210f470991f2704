"""Plain references of the configured models: plain PyTorch, importing nothing of the program."""
