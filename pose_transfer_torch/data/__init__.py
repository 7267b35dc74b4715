"""Compact batches, synthetic requests and in-step batch preparation."""
