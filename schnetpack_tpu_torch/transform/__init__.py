"""Host-side (numpy) transforms: neighbor lists and atomic data."""
