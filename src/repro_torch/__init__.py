"""Multi-FedLS in PyTorch for one NVIDIA H100: the port of ``repro``.

The JAX package ``repro`` stays the reference; this package mirrors its
modules and names, imports nothing of it (and no JAX), and runs on the
card by default (``device="cuda"`` on every entry point; the CPU only
when a caller asks for it).  Ported so far:

  federated.server.FLServer        round orchestration, §4.3 recovery
  federated.client.FLClient        local training and evaluation
  federated.agg_engine             flatten-once FedAvg reduce
  federated.async_server           async rounds, compressed updates
  configs, models.api, launch      the model zoo's serve path (dense,
                                   VLM and SSM families)
  kernels                          fedavg_reduce, dequant_fold,
                                   flash_attention, ssd_scan: CUDA
                                   kernels for sm_90a
  checkpoint, optim, data          what the round needs around it
"""
