"""Serving: paged KV cache, continuous scheduler, engine."""
