"""Model families: for each, the weights and silo data a cell makes from
its seed, and the system's model functions the FL clients call.  A
configuration file names its family (``"family"``); the harness loads
``fedbench/families/<family>.py`` by that name and the plain model from
``fedbench/reference/<family>.py``."""
