"""The plain reference of the benchmark's models and cascade: ``torch`` and
the configuration files only, nothing of the program under test."""
