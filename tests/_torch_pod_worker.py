"""One rank of a two-process gloo pod for ``tests/test_torch_hierarchy.py``.

Spawned children import this module (and torch and the port) only, never
the test module, which imports JAX.
"""
import torch
import torch.distributed as dist


def pod_rank(rank: int, world: int, init_file: str, out_file: str) -> None:
    """Reduce two stacks through ``ShardedPartialFolder`` and save what
    this rank saw: a replicated stack of 3 rows (padded to 4, so each rank
    sums 2), and a stack whose rows differ by rank, which shows the rows
    each rank summed."""
    from repro_torch.federated.hierarchy import ShardedPartialFolder

    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        folder = ShardedPartialFolder()
        same = [torch.full((16,), float(i + 1)) for i in range(3)]
        tagged = [torch.full((16,), float(10 ** i) * (rank + 1)) for i in range(4)]
        torch.save({"pod_size": folder.pod_size,
                    "same": folder.reduce(same),
                    "tagged": folder.reduce(tagged),
                    "n_collectives": folder.n_collectives}, out_file)
    finally:
        dist.destroy_process_group()
