"""Cross-cutting utilities: config, logging/tracing."""
