"""The plain reference of the benchmark: plain PyTorch, float32 with TF32
off, no kernel, cache or batching of the program's.

It imports neither JAX nor the JAX package nor anything of ``repro_torch``
(``fedbench/tests/test_fedbench_isolation.py`` scans for it).  It is handed
the inputs the harness made from the seed (initial weights, silo batches)
and works out again everything the program derives from them: every local
step, the AdamW rule, the int8 block codec, the weighted mean and the
evaluation loss.
"""
