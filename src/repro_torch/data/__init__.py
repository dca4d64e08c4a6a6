"""Synthetic data of the port (numpy RNG: bit-equal to the reference's)."""
