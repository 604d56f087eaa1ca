"""Host-side data: uint8 <-> model-space conversion and eval sets."""
