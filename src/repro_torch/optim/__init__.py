"""AdamW, its schedule and the per-trial hyperparameters."""
