"""The LM stack's optimizer (port of ``repro.optim``)."""
