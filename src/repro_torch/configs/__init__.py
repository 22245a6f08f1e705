"""Model configurations, as plain data."""
