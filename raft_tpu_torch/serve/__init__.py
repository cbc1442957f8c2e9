"""The port's serving layer.  Only :class:`buckets.SlotPhysics`, the key
of the waterfall's phase programs, is ported so far (ROADMAP.md, queue 1
step 12 holds the rest)."""
