"""One rank of a two-process gloo pod for ``tests/test_torch_hierarchy.py``
(``pod_rank``) and ``tests/test_torch_sharding.py`` (``mesh_rank``).

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


def mesh_rank(rank: int, world: int, init_file: str, out_file: str) -> None:
    """Place tensors on a ``data=2`` DeviceMesh by their specs and save what
    this rank holds: each local shard, each ``full_tensor()``, and whether
    a spec naming an axis the mesh lacks raised."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.rules import PartitionSpec as P
    from repro_torch.sharding.rules import distribute, to_named

    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        mesh = make_host_mesh(data=2, model=1, device_type="cpu")
        tree = {"a": torch.arange(24.0).reshape(4, 6), "b": [torch.arange(12.0).reshape(2, 6)],
                "c": torch.arange(8.0)}
        specs = {"a": P("data", "model"), "b": [P(None, "data")], "c": P(None)}
        placed = distribute(tree, mesh, specs)
        try:
            to_named(mesh, {"x": P("pod", None)})
            raised = False
        except ValueError:
            raised = True
        named = to_named(mesh, specs)
        named["b"] = named["b"][0]
        torch.save({"placements": {k: [("shard", p.dim) if p.is_shard() else ("replicate",)
                                       for p in v] for k, v in named.items()},
                    "local": {"a": placed["a"].to_local(), "b": placed["b"][0].to_local(),
                              "c": placed["c"].to_local()},
                    "full": {"a": placed["a"].full_tensor(), "b": placed["b"][0].full_tensor(),
                             "c": placed["c"].full_tensor()},
                    "missing_axis_raised": raised}, out_file)
    finally:
        dist.destroy_process_group()
