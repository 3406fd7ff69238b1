"""Tree arrays, the leaf-wise grower, objectives and metrics."""
