"""The plain reference of the benchmark's check (imports nothing of the
program)."""
