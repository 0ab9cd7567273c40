"""GraphLab programs."""
