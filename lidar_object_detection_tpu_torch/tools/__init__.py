"""Measurement scripts for the card (``python -m ...tools.<name>``)."""
