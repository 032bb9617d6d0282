"""The benchmark's own machinery: the manifest, scenes, weights, the
yardstick's arithmetic, tracing and the run's result."""
