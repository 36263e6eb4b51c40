"""Step functions and the serving driver for the model zoo, the port of
``repro.launch`` (prefill and serve so far)."""
