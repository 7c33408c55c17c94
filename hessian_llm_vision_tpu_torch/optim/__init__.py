"""Optimizers: torch-convention SGD and host-driven LanczosSGD."""
