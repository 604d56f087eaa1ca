"""Host-side data: uint8 <-> model-space conversion, the training batch
stage (LR synthesis, dihedral augmentation), the corpora (procedural,
``natural`` photographs, image folders, ``synthetic_device`` rendered on
the training device), the native PNG decoder and crop sampler, the
training crop stream and eval sets."""
