"""Plain PyTorch references of the port's models (no kernel of the port)."""
