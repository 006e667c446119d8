"""The LM stack's train step and gradient compression (port of
``repro.train``)."""
