"""Curvature-vector products."""
