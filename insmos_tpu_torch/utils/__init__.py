"""Parameters, checkpoints, the reference checkpoint converter and the
prediction artifacts."""
