"""Synthetic data for the port (numpy generation, torch tensors)."""
