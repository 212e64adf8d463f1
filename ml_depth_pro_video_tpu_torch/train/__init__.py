"""Training: the loss and AdamW step, the data feed, the fit loop and distillation."""
