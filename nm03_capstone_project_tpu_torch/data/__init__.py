"""Synthetic phantoms and cohorts."""
