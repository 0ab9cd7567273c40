"""Entry points: serving steps and the LM serving driver."""
