"""Generators under test and their registry."""
