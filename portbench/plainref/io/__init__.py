"""Model I/O (numpy only)."""
