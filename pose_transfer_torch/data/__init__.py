"""Annotations, pair files, the file-backed dataset and its loader, compact
batches, synthetic data and in-step batch preparation."""
