"""Streaming evaluation and scoring of the port."""
