"""One module per kind of cell, named by a traffic file's `driver` key."""
