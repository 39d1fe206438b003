"""Runtime substrate: config, device context, file IO, training triggers,
utilities."""
