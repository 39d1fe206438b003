"""Runtime substrate: config, device context, file IO, utilities."""
