"""Sample grids, image files, model summaries and the span recorder."""
