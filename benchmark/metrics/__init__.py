"""Per-layer metric readers: ``metrics/<family>.py`` reads the metrics
named ``<family>`` or ``<family>.<variant>`` with ``read(ctx, name)``, from
the traced run's spans, profiler trace and the configuration's shapes, and
returns None where it finds nothing to read."""
