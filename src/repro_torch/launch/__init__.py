"""Entry points run as ``python -m``."""
