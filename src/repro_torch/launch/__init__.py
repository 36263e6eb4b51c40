"""Step functions, the serving driver, the trainer, meshes and input
specs for the model zoo, the port of ``repro.launch`` (all but the
dry-run)."""
