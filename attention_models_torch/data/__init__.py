"""Datasets, the reference's image transform and the seeded loader."""
