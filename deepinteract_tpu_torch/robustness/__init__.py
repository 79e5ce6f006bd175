"""Failure handling around training: the non-finite step guard."""
