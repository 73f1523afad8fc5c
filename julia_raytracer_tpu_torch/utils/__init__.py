"""Host utilities: counter-based RNG, vector math, color conversions."""
