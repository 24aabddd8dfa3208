"""The yardstick's shared parts: the manifest, the window, statistics,
the trace reader, operation and byte counts, peaks, seeded weights and
scenes, the lower-precision control and the import guard."""
