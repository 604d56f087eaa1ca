"""Training of the port: the L1 pretrain phase (state, step, checkpoints,
loop).  The GAN phase is not ported yet."""
