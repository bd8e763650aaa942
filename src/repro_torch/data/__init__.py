"""Training data pipelines."""
