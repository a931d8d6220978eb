"""Device resolution and the sync data-parallel engine."""
