"""Parameter-dict utilities."""
