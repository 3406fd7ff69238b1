"""Data layer: binning, the binned dataset and the model text format."""
