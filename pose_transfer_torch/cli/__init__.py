"""Command-line entry points: dataset writing, pair files, training,
inference grids and evaluation."""
