"""Models on the text-to-image serving path."""
