"""Detection, description, matching and their kernels."""
