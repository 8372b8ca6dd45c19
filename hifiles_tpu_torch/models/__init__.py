"""Physical models of the port that act at boundary points."""
