"""Serving: the batched engine and the decode-plan router."""
