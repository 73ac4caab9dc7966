"""Conversion helpers of the port."""
