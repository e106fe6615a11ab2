"""Two-view geometry: homogeneous helpers, Hartley normalization, eigen-solvers, F estimation, RANSAC."""
