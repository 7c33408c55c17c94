"""Data generators (numpy, seeded)."""
