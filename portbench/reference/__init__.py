"""The plain references that decide ``correct``: plain PyTorch, frozen
copies of the port's plain semantics, importing nothing of the port and
taking nothing that the program made."""
