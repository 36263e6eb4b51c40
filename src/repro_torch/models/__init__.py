"""The paper's FL application models.  The model zoo and the LoRA helpers
of the reference's ``repro.models`` arrive in later slices."""
