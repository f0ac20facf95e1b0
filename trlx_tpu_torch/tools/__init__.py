"""Measurement tools that run on the card (not imported by the package)."""
