"""Host-side geometry: point clouds, kNN, orderings, in-block coloring."""
