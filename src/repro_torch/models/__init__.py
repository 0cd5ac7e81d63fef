"""Model pieces of the port."""
