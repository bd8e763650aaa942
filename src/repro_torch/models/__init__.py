"""Model layers, attention and the dense transformer."""
