"""Embedding-bag kernel (K4)."""
