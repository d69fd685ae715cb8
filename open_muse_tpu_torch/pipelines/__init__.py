"""Text-to-image pipelines."""
