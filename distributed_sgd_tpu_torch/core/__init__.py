"""Host-side training state, stopping rules and the epoch driver."""
