"""The port's copies of the environment, application and cost models and of
the §4.4 Dynamic Scheduler against the reference's.

Both packages get the same environments and applications (the published
testbeds, and the toy builders of tests/conftest.py converted field by
field), and every number the cost model gives and every decision
``DynamicScheduler.select_instance`` makes must be equal: the modules
are copies and do the same float arithmetic in the same order.
``to_cost_model_sizes`` must give the reference's sizes for the same
message log.

The converters below (``port_env``, ``port_app``) are what the live
transport and chaos tests use to build a port ``CostModel``.
"""
import dataclasses

import pytest

from conftest import make_toy_app, make_toy_env
from repro import core as rcore
from repro.federated.messages import RoundMessageLog as JaxLog
from repro.federated.messages import to_cost_model_sizes as jax_sizes
from repro_torch import core as tcore
from repro_torch.federated.messages import RoundMessageLog, to_cost_model_sizes


def port_env(env):
    """A reference CloudEnvironment rebuilt from the port's classes."""
    out = tcore.CloudEnvironment(
        [tcore.Provider(**dataclasses.asdict(p)) for p in env.providers.values()],
        [tcore.Region(**dataclasses.asdict(r)) for r in env.regions.values()],
        [tcore.VMType(**dataclasses.asdict(v)) for v in env.vm_types.values()],
    )
    out.sl_comm = dict(env.sl_comm)
    out.sl_inst = dict(env.sl_inst)
    return out


def port_app(app):
    """A reference FLApplication rebuilt from the port's classes."""
    fields = {f.name: getattr(app, f.name) for f in dataclasses.fields(app)}
    fields["clients"] = [tcore.ClientSpec(**dataclasses.asdict(c)) for c in app.clients]
    fields["messages"] = tcore.MessageSizes(**dataclasses.asdict(app.messages))
    return tcore.FLApplication(**fields)


# (name, reference environment, reference application, port environment,
#  port application): the published testbeds from each package's own
# builders, the toy ones converted.
SETUPS = {
    "cloudlab-femnist": (rcore.cloudlab_environment, rcore.femnist_application,
                         tcore.cloudlab_environment, tcore.femnist_application),
    "cloudlab-til": (rcore.cloudlab_environment, rcore.til_application,
                     tcore.cloudlab_environment, tcore.til_application),
    "cloudlab-shakespeare": (rcore.cloudlab_environment, rcore.shakespeare_application,
                             tcore.cloudlab_environment, tcore.shakespeare_application),
    "aws_gcp-til_aws": (rcore.aws_gcp_environment, rcore.til_application_aws,
                        tcore.aws_gcp_environment, tcore.til_application_aws),
    "toy": (lambda: make_toy_env(n_vms=3), lambda: make_toy_app(n_clients=3),
            lambda: port_env(make_toy_env(n_vms=3)),
            lambda: port_app(make_toy_app(n_clients=3))),
}


def _models(name, alpha=0.5):
    renv, rapp, tenv, tapp = SETUPS[name]
    return rcore.CostModel(renv(), rapp(), alpha), tcore.CostModel(tenv(), tapp(), alpha)


def _placement(module, cm, spot_every=2):
    """Every task on a VM of its own where there are enough, cycling the
    sorted VM ids; every ``spot_every``-th client on the spot market."""
    vms = sorted(cm.env.vm_types)
    out = {module.SERVER: module.Assignment(vms[0], "on_demand")}
    for i, c in enumerate(cm.app.clients):
        market = "spot" if i % spot_every == 0 else "on_demand"
        out[c.client_id] = module.Assignment(vms[(i + 1) % len(vms)], market)
    return out


@pytest.mark.parametrize("build", [
    (rcore.cloudlab_environment, tcore.cloudlab_environment),
    (rcore.aws_gcp_environment, tcore.aws_gcp_environment),
], ids=["cloudlab", "aws_gcp"])
def test_environments_equal(build):
    ref, port = build[0](), build[1]()
    assert [dataclasses.asdict(v) for v in ref.vm_types.values()] == \
        [dataclasses.asdict(v) for v in port.vm_types.values()]
    assert [dataclasses.asdict(r) for r in ref.regions.values()] == \
        [dataclasses.asdict(r) for r in port.regions.values()]
    assert [dataclasses.asdict(p) for p in ref.providers.values()] == \
        [dataclasses.asdict(p) for p in port.providers.values()]
    assert ref.sl_comm == port.sl_comm and ref.sl_inst == port.sl_inst


@pytest.mark.parametrize("name", ["femnist_application", "til_application",
                                  "til_application_aws", "shakespeare_application"])
def test_applications_equal(name):
    ref, port = getattr(rcore, name)(), getattr(tcore, name)()
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)


@pytest.mark.parametrize("name", list(SETUPS))
def test_cost_model_numbers_equal(name):
    ref, port = _models(name)
    assert ref.t_max() == port.t_max()
    assert ref.cost_max() == port.cost_max()
    rplace, tplace = _placement(rcore, ref), _placement(tcore, port)
    assert dataclasses.asdict(ref.evaluate(rplace)) == dataclasses.asdict(port.evaluate(tplace))
    assert ref.capacity_ok(rplace) == port.capacity_ok(tplace)
    server = rplace[rcore.SERVER].vm_id
    for c in ref.app.clients:
        vm = rplace[c.client_id].vm_id
        assert ref.client_round_time(c.client_id, vm, server) == \
            port.client_round_time(c.client_id, vm, server)
    offsets = {c.client_id: 10.0 * (i + 1) for i, c in enumerate(ref.app.clients)}
    assert ref.async_round_time(offsets, server) == port.async_round_time(offsets, server)


@pytest.mark.parametrize("name", list(SETUPS))
def test_update_message_sizes_moves_both_models_alike(name):
    ref, port = _models(name)
    before = port.cost_max()
    ref.update_message_sizes(rcore.MessageSizes(0.25, 0.5, 0.0625, 1e-6))
    port.update_message_sizes(tcore.MessageSizes(0.25, 0.5, 0.0625, 1e-6))
    assert dataclasses.asdict(ref.app.messages) == dataclasses.asdict(port.app.messages)
    assert ref.cost_max() == port.cost_max() != before
    assert ref.t_max() == port.t_max()


@pytest.mark.parametrize("name", list(SETUPS))
@pytest.mark.parametrize("remove_revoked", [True, False])
def test_select_instance_decides_as_the_reference(name, remove_revoked):
    """Every client revoked in turn, twice over (the second revocation
    sees the first's cooldown): the same replacement VM, market and
    objective in both packages."""
    ref_cm, port_cm = _models(name)
    rsched, tsched = rcore.DynamicScheduler(ref_cm), tcore.DynamicScheduler(port_cm)
    rplace, tplace = _placement(rcore, ref_cm), _placement(tcore, port_cm)
    for rep in range(2):
        for i, c in enumerate(ref_cm.app.clients):
            cid = c.client_id
            now = 100.0 * (rep * len(ref_cm.app.clients) + i)
            want = rsched.select_instance(cid, rplace, rplace[cid].vm_id,
                                          remove_revoked=remove_revoked, now_s=now)
            got = tsched.select_instance(cid, tplace, tplace[cid].vm_id,
                                         remove_revoked=remove_revoked, now_s=now)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            rplace[cid] = rcore.Assignment(want.new_vm, want.market)
            tplace[cid] = tcore.Assignment(got.new_vm, got.market)


def test_select_instance_with_the_toy_scheduler_of_the_chaos_tests():
    """``DynamicScheduler(CostModel(env, app, 0.5))`` as the chaos tests
    build it: a revoked silo always moves off its VM."""
    sched = tcore.DynamicScheduler(
        tcore.CostModel(port_env(make_toy_env(n_vms=3)), port_app(make_toy_app(n_clients=3)), 0.5))
    place = {cid: tcore.Assignment("vm0", "spot") for cid in ("s", "c0", "c1", "c2")}
    for cid in ("c0", "c1", "c2"):
        decision = sched.select_instance(cid, place, place[cid].vm_id)
        assert decision.new_vm != "vm0"
        place[cid] = tcore.Assignment(decision.new_vm, decision.market)


@pytest.mark.parametrize("log", [
    dict(s_msg_train_bytes=656_706_443, c_msg_train_bytes=656_706_443,
         s_msg_aggreg_bytes=656_706_443, c_msg_test_bytes=31),
    dict(s_msg_train_bytes=656_706_443, c_msg_train_bytes=164_277_418,
         s_msg_aggreg_bytes=656_706_443, c_msg_test_bytes=31, codec="int8",
         c_msg_train_dense_bytes=656_748_280),
    dict(s_msg_train_bytes=68, c_msg_train_bytes=41, s_msg_aggreg_bytes=68,
         c_msg_test_bytes=15, codec="structured:int8", c_msg_train_dense_bytes=12,
         group_wire_bytes={"a": 41}, group_dense_bytes={"a": 12}),
], ids=["dense", "int8", "structured"])
def test_to_cost_model_sizes_equals_reference(log):
    want = jax_sizes(JaxLog(**log))
    got = to_cost_model_sizes(RoundMessageLog(**log))
    assert isinstance(got, tcore.MessageSizes)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    # Always the wire size, never the dense equivalent.
    assert got.c_msg_train_gb == log["c_msg_train_bytes"] / 1e9


def port_toy_env(**kw):
    """``conftest.make_toy_env`` rebuilt from the port's classes."""
    return port_env(make_toy_env(**kw))


def port_toy_app(**kw):
    """``conftest.make_toy_app`` rebuilt from the port's classes."""
    return port_app(make_toy_app(**kw))
