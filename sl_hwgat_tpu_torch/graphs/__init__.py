"""Skeleton topology and adjacency masks of the windowed models."""
