"""Metric loggers and timers."""
