"""Layers of the port: embeddings, dense, attention, transformer blocks."""
