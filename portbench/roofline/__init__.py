"""Frozen counts of the kernels' work and the card's published peaks."""
