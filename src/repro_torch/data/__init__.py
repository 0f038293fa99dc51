"""The synthetic-token data pipeline (the port's copy of repro.data)."""
