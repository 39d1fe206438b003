"""Tracing utilities: ``utils.trace`` records ``time_it`` spans and
request flow chains as Chrome-trace JSON."""
