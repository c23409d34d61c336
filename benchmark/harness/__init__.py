"""The benchmark's harness: it finds a cell's files by name, builds the
program under test (``news_recsys_tpu_torch``) from seeded inputs, runs the
cell's traffic driver, judges its answers against the plain reference and
prints the result line."""
