"""Model layers, the decoder LM, and the weight bridge from the JAX package."""
