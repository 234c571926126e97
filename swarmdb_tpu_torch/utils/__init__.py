"""Host utilities: locks, hashing, metrics, device resolution and the
numpy -> torch parameter carrier."""
