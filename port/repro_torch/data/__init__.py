"""Synthetic spatial datasets."""
