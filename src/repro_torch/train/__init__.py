"""The fault-tolerant training loop and its metrics."""
