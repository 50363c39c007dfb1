"""Windowed prediction engine and MSS post-processing."""
