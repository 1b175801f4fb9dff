"""Models of the port's serving paths (twin of ``repro.models``): shared
layers, DIN, the MoE layer and the decoder-only LM. Parameters are plain
dictionaries of tensors laid out like the JAX package's pytrees."""
