"""Measured twins of the reference's paper benches, timed on the card."""
