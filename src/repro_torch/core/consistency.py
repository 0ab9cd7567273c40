"""Consistency models (paper Sec. 3.4).

Full / edge / vertex consistency define which scope regions an update may
touch concurrently with others; the engines realize them structurally:

  chromatic engine : full  -> distance-2 coloring
                     edge  -> distance-1 (proper) coloring
                     vertex-> single color (all vertices simultaneously)
  dynamic engine   : full  -> distance-2 exclusion in the per-step MIS
                     edge  -> distance-1 exclusion
                     vertex-> no exclusion

(paper Sec. 4.2.1: "We can satisfy the other consistency models simply by
changing how the vertices are colored.")
"""
from __future__ import annotations

import enum


class Consistency(enum.Enum):
    FULL = "full"      # exclusive R/W on entire scope
    EDGE = "edge"      # R/W vertex + adjacent edges, R-only adjacent vertices
    VERTEX = "vertex"  # R/W own vertex only

    @property
    def exclusion_radius(self) -> int:
        """Graph distance within which two concurrent updates conflict."""
        return {Consistency.FULL: 2, Consistency.EDGE: 1,
                Consistency.VERTEX: 0}[self]
