"""Network modules of the port (eval forward)."""
