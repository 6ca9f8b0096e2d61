"""Skeleton topology and attention masks of the graph-attention models."""
