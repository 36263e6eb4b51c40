"""Step functions, the serving driver, the trainer, meshes, input specs
and the dry-run for the model zoo, the port of ``repro.launch``."""
