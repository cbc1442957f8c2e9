"""Entry drivers: one per kind of entry point of the system under test.
A traffic mix names its driver (``"entry"``); the driver builds the
system from the configuration's file and the seed, warms it up, runs one
step of the window at a time, and checks the window's outputs against the
plain reference.

Each module has ``Entry(config, traffic, seed, device)`` with
``setup()``, ``step(i) -> {"units": n, ...}``, ``outcome(records) ->
(attempted, failed)``, ``free()`` and ``check(records, limits, device)
-> {name: {"value", "limit"}}``."""
