"""The port stands alone: importing all of it loads no JAX, nothing of the
reference package, and neither msgpack nor ml_dtypes (the machine with
the card has none of them)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack", "ml_dtypes")


def _modules():
    out = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(SRC).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_importing_every_module_loads_no_forbidden_package():
    code = (
        "import importlib, sys\n"
        f"mods = {_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split()[0] == str(len(_modules()))


@pytest.mark.parametrize("module", _modules())
def test_no_forbidden_import_in_source(module):
    rel = Path(*module.split("."))
    path = SRC / rel / "__init__.py" if (SRC / rel).is_dir() else (SRC / rel).with_suffix(".py")
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


EXAMPLE = SRC.parent / "examples" / "quickstart_torch.py"


def test_quickstart_example_loads_no_forbidden_package():
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('quickstart_torch', {str(EXAMPLE)!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], env=dict(os.environ), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_quickstart_example_imports_no_forbidden_package_in_source():
    tree = ast.parse(EXAMPLE.read_text(), filename=str(EXAMPLE))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{EXAMPLE}:{node.lineno} {name}"


def test_chip_smoke_imports_no_forbidden_package():
    path = SRC.parent / "chip_smoke.py"
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"chip_smoke.py:{node.lineno} {name}"


def test_entry_points_default_to_the_card():
    import inspect

    from repro_torch import convert
    from repro_torch.federated import (
        FLClient, FLServer, LiveRoundDriver, ProcessWorkerPool, ThreadWorkerPool)
    from repro_torch.models import fl_models

    for fn in (FLServer.__init__, FLClient.__init__, fl_models.init_femnist_cnn,
               fl_models.init_vgg16, fl_models.init_shakespeare_lstm,
               convert.params_from_numpy, convert.tensor_from_numpy,
               LiveRoundDriver.__init__, ThreadWorkerPool.__init__,
               ProcessWorkerPool.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__

    import importlib.util

    spec = importlib.util.spec_from_file_location("quickstart_torch", EXAMPLE)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    assert inspect.signature(example.main).parameters["device"].default == "cuda"


@pytest.mark.parametrize("chain", ["barrier", "hierarchy", "thread transport"])
def test_servers_the_builder_makes_default_to_the_card(chain):
    """``Experiment.serve`` without ``device=`` leaves each server's own
    default, the card: with no card the server cannot be built, and with
    one its weights land there."""
    import torch

    from repro_torch.core import Experiment
    from repro_torch.federated.client import ClientResult, EvalResult

    class Stub:
        client_id = "c0"

        def train(self, params):
            return ClientResult("c0", params, 1, 0.0)

        def evaluate(self, params):
            return EvalResult("c0", {}, 1, 0.0)

    exp = {"barrier": Experiment(), "hierarchy": Experiment().hierarchy(regions=1),
           "thread transport": Experiment().transport()}[chain]
    params = {"w": torch.zeros(3)}
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            exp.serve([Stub()], params)
        return
    server = exp.serve([Stub()], params)
    assert server.params["w"].is_cuda
    if chain == "thread transport":
        assert server.workers._template["w"].is_cuda
        server.close()


@pytest.mark.parametrize("module", [
    "repro_torch.launch.train", "repro_torch.launch.steps", "repro_torch.optim.optimizers",
    "repro_torch.models.fl_models", "repro_torch.federated.agg_engine",
    "repro_torch.federated.compression", "repro_torch.federated.messages",
    "repro_torch.kernels.flash_attention",
])
def test_the_training_slice_modules_are_scanned(module):
    assert module in _modules()


@pytest.mark.parametrize("module", [
    "repro_torch.core.application_model", "repro_torch.core.cloud_model",
    "repro_torch.core.cost_model", "repro_torch.core.dynamic_scheduler",
    "repro_torch.federated.chaos", "repro_torch.federated.transport",
])
def test_the_live_transport_modules_are_scanned(module):
    assert module in _modules()


def test_trainer_and_server_default_to_the_card():
    import inspect

    from repro_torch.launch import serve, train

    for mod in (train, serve):
        assert 'ap.add_argument("--device", default="cuda"' in inspect.getsource(mod.main)


@pytest.mark.parametrize("module", [
    "repro_torch.core.pre_scheduling", "repro_torch.core.initial_mapping",
    "repro_torch.core.fault_tolerance", "repro_torch.core.autopilot",
    "repro_torch.core.simulator", "repro_torch.core.control_plane",
])
def test_the_resource_manager_modules_are_scanned(module):
    assert module in _modules()


@pytest.mark.parametrize("module", [
    "repro_torch.sharding", "repro_torch.sharding.context", "repro_torch.sharding.rules",
    "repro_torch.roofline", "repro_torch.roofline.analysis", "repro_torch.roofline.hardware",
    "repro_torch.launch.mesh", "repro_torch.launch.specs", "repro_torch.federated.pod_fedavg",
])
def test_the_pod_and_sharding_modules_are_scanned(module):
    assert module in _modules()


def test_pod_entry_points_default_to_the_card():
    import inspect

    from repro_torch.data import batch_iterator
    from repro_torch.federated import init_pod_state
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

    assert inspect.signature(init_pod_state).parameters["device"].default == "cuda"
    assert inspect.signature(batch_iterator).parameters["device"].default == "cuda"
    for fn in (make_host_mesh, make_production_mesh):
        assert inspect.signature(fn).parameters["device_type"].default == "cuda"
