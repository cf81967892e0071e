"""Per-layer metric readers. ``metrics/<metric>.json`` names one of these
modules and its arguments; ``read(ctx, **args)`` returns the metric's value
or None when the run holds nothing to read (the harness then leaves the
metric out of the line)."""
