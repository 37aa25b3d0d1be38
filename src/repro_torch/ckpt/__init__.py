"""Checkpoints: npz payloads, a JSON manifest and a durable pointer."""
