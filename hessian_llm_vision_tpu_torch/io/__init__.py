"""Spectrum artifacts, checkpoints and run directories."""
