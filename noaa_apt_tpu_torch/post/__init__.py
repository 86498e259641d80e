"""Image-space post-processing (host)."""
