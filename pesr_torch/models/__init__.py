"""Generator (plain PyTorch reference) and its kernel-backed applies
(inference and training)."""
