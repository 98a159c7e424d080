"""Helpers that need no device: the glibc rand() replica."""
