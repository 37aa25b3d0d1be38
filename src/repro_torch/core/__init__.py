"""Dataflow specs and the port's kernel registry."""
