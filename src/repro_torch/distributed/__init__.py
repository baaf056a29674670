"""Step builders of the port (serving steps in this slice)."""
