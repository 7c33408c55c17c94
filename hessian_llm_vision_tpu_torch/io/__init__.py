"""Spectrum artifact IO."""
