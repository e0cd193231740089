"""Work counts for the per-layer roofline shares, from shapes alone."""
