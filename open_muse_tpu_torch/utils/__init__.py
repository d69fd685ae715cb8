"""Training utilities."""
