"""The training step: loss, gradients, microbatches, the optimizer."""
