"""Networks of the port (eval mode)."""
