"""Deterministic, step-addressed synthetic LM batches."""
from repro_torch.data.pipeline import SyntheticLMDataset
