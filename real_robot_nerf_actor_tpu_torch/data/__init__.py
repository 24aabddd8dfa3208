"""Robot I/O protocol, replay stub and the synthetic scene (numpy only)."""
