"""Synthetic datasets (numpy, made from a seed)."""
