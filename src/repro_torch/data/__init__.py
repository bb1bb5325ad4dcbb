"""Synthetic data: the seeded LM and multimodal batch generators."""
