"""Fault injection, health ledger and kernel degradation."""
