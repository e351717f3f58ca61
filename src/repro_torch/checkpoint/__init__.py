"""Atomic, digest-verified checkpoints of nested dicts of tensors."""
