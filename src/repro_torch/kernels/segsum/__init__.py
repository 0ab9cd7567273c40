"""Sorted segment-sum kernel (K3)."""
