"""Parameter init and loading."""
