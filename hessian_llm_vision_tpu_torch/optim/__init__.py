"""Optimizers: SGD, Adam and raw SGD update rules, LR schedules, and
host-driven LanczosSGD."""
