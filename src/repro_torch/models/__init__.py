"""Models of the zoo: DLRM and the dense decoder-only LM."""
