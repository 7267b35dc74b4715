"""Generator construction and the inference step."""
