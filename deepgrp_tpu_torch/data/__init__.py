"""Input readers."""
