"""Several videos through one card: the batched pipeline."""
