"""Host-side utilities of the port: checkpoints, metric logging, image grids."""
