"""Layers, sampling primitives and vector quantization."""
