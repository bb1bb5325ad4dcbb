"""Serving: continuous-batching scheduler and the chunked-prefill engine."""
