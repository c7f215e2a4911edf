"""Counter-based threefry RNG (the slice's only sampler)."""
