"""Plain PyTorch references and frozen counts: no kernel, nothing of
``pesr_torch``."""
