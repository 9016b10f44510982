"""Step builders (serving builders only in this slice)."""
