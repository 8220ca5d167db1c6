"""The harness: cells, traffic, the driven engine, trace and check."""
