"""AdamW with global-norm clipping and a warmup-cosine schedule."""
