"""Generator (plain PyTorch reference) and its kernel-backed apply."""
