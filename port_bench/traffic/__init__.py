"""Traffic: the photo renderer and the one generator that reads every
mix file."""
