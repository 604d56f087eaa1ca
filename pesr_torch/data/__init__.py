"""Host-side data: uint8 <-> model-space conversion, the training batch
stage (LR synthesis, dihedral augmentation), the training crop stream
and eval sets."""
