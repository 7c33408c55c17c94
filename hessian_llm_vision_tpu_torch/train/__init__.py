"""Training loop, micro-batching and evaluation."""
