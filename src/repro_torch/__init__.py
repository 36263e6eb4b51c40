"""Multi-FedLS in PyTorch for one NVIDIA H100: the port of ``repro``.

The JAX package ``repro`` stays the reference; this package mirrors its
modules and names, imports nothing of it (and no JAX), and runs on the
card by default (``device="cuda"`` on every entry point; the CPU only
when a caller asks for it).  Ported so far — the main path, one
cross-silo FedAvg round:

  federated.server.FLServer        round orchestration, §4.3 recovery
  federated.client.FLClient        local training and evaluation
  federated.agg_engine             flatten-once FedAvg reduce
  kernels.fedavg_reduce            the reduce, a CUDA kernel for sm_90a
  checkpoint, optim, data, models  what the round needs around it
"""
