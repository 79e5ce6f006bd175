"""Graph containers, npz I/O and featurization (torch/numpy copies)."""
