"""Collective-algorithm trace generators (a copy of the reference's)."""
