"""Training observability and WAV input/output."""
