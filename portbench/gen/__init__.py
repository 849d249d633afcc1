"""Seeded input generators of the benchmark (numpy only): the same seed
gives the same inputs, bit for bit."""
