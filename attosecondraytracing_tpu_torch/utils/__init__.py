"""Console logging and result persistence."""
