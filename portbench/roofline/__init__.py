"""The roofline: the H100's published peaks, and the operations and bytes
of each kernel's work, counted from shapes and from what the reference
counted on the same inputs (never from the program's counters)."""
