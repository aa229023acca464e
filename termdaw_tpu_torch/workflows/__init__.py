"""Frontends: the manual command workflow."""
