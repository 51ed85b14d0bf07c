"""Machine configurations."""
