"""Framework-free helpers (logging)."""
