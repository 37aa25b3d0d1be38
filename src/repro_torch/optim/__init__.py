"""AdamW, learning-rate schedules and gradient quantization."""
from repro_torch.optim.adamw import AdamW, AdamWState, global_norm
from repro_torch.optim import compress, schedules
