"""Fused gather⊕combine (K1) and scatter/reschedule (K2) kernels."""
