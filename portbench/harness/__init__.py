"""The harness: the cell's files, the window, its trace and the check."""
