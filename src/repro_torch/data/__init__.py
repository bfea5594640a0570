"""Synthetic datasets, generated from a seed on the target device."""
