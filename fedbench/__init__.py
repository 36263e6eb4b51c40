"""The benchmark of the PyTorch port (``repro_torch``): cross-silo FedAvg
rounds timed end to end on one NVIDIA H100.  Run a cell with

    python3 fedbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (see ``fedbench/run.py``)."""
