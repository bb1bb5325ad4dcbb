"""Optimization: AdamW on trees of tensors, gradient accumulation and the
int8 error-feedback leaf compression."""
