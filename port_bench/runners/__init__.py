"""One module per kind of cell, named by a mix's ``runner`` key."""
