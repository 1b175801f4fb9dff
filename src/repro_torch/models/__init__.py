"""Models of the port (twin of ``repro.models``): shared layers, DIN, the
MoE layer, the decoder-only LM, the GNNs and MACE. Parameters are plain
dictionaries of tensors laid out like the JAX package's pytrees."""
