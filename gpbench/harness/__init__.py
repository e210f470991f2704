"""The harness: registry, drivers of each traffic kind, tracing, the import guard."""
