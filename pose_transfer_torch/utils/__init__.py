"""Sample grids, image files and model summaries."""
