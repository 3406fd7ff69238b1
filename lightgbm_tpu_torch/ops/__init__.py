"""Device ops: histogram construction and the split scan."""
