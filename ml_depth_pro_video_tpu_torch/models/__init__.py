"""ViT backbone and the Depth Pro model."""
