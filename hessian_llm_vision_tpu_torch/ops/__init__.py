"""Spectral gradient transforms and the hand-written CUDA kernels."""
