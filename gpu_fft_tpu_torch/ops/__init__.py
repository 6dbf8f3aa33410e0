"""Public transform and spectral operations."""
