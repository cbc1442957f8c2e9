"""Frozen arithmetic of work and peaks: operations and bytes computed
from shapes, and the card's published rates, for the roofline shares."""
