"""HTTP depth serving with micro-batching."""
