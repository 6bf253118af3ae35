"""Host-side utilities: the synthetic scene, tracker-state checkpoints and
the profiling entry point."""
