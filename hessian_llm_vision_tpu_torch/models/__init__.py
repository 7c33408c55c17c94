"""Models and loss closures."""
