"""Small host utilities: device selection, PNG writing, running means,
host-heap trimming."""
