"""Configuration, weight conversion and loading."""
