"""Network modules of the port (eval and train forward)."""
