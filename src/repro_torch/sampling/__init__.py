"""Keyed chunk permutations and the committed chunk schedule."""
