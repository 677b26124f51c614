"""Training objectives' losses."""
