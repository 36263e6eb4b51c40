"""Application model (paper §3).

This is the port's own copy of ``repro/core/application_model.py``, which uses no JAX:
the same classes, fields and arithmetic, so both packages' schedulers
make the same decisions.  The port imports nothing of the JAX package;
the text below is the reference's, and its module names point into
that package.

A Cross-Silo FL application: one server s and a set of clients C, executing
n_rounds communication rounds. Each round has a training phase and an
evaluation phase with four message kinds whose sizes drive the comm-cost
model (Eq. 6).

Message sizes are in GB (the paper's cost_t_j is $/GB).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class MessageSizes:
    """size(s_msg_train), size(s_msg_aggreg), size(c_msg_train), size(c_msg_test) in GB."""

    s_msg_train_gb: float
    s_msg_aggreg_gb: float
    c_msg_train_gb: float
    c_msg_test_gb: float

    @classmethod
    def from_model_bytes(cls, model_bytes: int, metrics_bytes: int = 4096) -> "MessageSizes":
        """Server->client and client->server training messages carry the full
        weights; the test message carries only scalar ML metrics."""
        gb = model_bytes / 1e9
        return cls(
            s_msg_train_gb=gb,
            s_msg_aggreg_gb=gb,
            c_msg_train_gb=gb,
            c_msg_test_gb=metrics_bytes / 1e9,
        )


@dataclasses.dataclass(frozen=True)
class ClientSpec:
    """A client c_i with its baseline execution times (from Pre-Scheduling).

    train_bl / test_bl: seconds on the baseline VM for one round's local
    training / evaluation.
    """

    client_id: str
    train_bl: float
    test_bl: float
    n_train_samples: int = 0
    n_test_samples: int = 0
    # Optional pin: region where this client's silo (dataset) lives. The
    # scheduler may restrict the client's candidate VM set to this region's
    # provider when `pin_to_silo` is set on the app.
    silo_region: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class FLApplication:
    """A Cross-Silo FL application instance.

    Attributes mirror the paper's notation: deadline T and budget B for the
    whole run are divided by n_rounds to give per-round T_round / B_round.
    """

    name: str
    clients: List[ClientSpec]
    messages: MessageSizes
    n_rounds: int
    # Baseline message-exchange times (seconds) in the baseline region pair:
    train_comm_bl: float
    test_comm_bl: float
    # Server aggregation time on the baseline VM (seconds); scaled by sl_inst.
    aggreg_bl: float = 1.0
    deadline_s: Optional[float] = None   # T
    budget_usd: Optional[float] = None   # B
    epochs_per_round: int = 1
    checkpoint_bytes: int = 0            # model checkpoint size (§5.5: 504 MB for TIL)

    @property
    def n_clients(self) -> int:
        return len(self.clients)

    @property
    def t_round(self) -> Optional[float]:
        """T_round = T / n_rounds."""
        if self.deadline_s is None:
            return None
        return self.deadline_s / self.n_rounds

    @property
    def b_round(self) -> Optional[float]:
        """B_round = B / n_rounds."""
        if self.budget_usd is None:
            return None
        return self.budget_usd / self.n_rounds

    def client(self, client_id: str) -> ClientSpec:
        for c in self.clients:
            if c.client_id == client_id:
                return c
        raise KeyError(client_id)


# ---------------------------------------------------------------------------
# The paper's three applications (§5.1) with their published baselines (§5.4).
# ---------------------------------------------------------------------------

def til_application(n_rounds: int = 10) -> FLApplication:
    """TIL use-case: 4 clients, VGG16-style CNN, 948 train / 522 test samples
    each. Baseline per-client execution 2765.4 s (train+test); communication
    baseline 8.66 s (§5.4). Training messages exchange ~2 GB total and test
    ~1 GB per §5.3 ⇒ model weights ~0.5 GB (VGG16 ≈ 528 MB); checkpoint 504 MB
    (§5.5)."""
    # The 2765.4 s baseline covers train+test; split it with the same ratio as
    # Table 3's baseline VM (vm_121: 116.36 train vs 2.26 test per 38/21-sample
    # probe), i.e. ~98% train.
    train_frac = 0.981
    clients = [
        ClientSpec(
            client_id=f"til_client_{i}",
            train_bl=2765.4 * train_frac,
            test_bl=2765.4 * (1.0 - train_frac),
            n_train_samples=948,
            n_test_samples=522,
        )
        for i in range(4)
    ]
    msgs = MessageSizes(
        s_msg_train_gb=0.504,
        s_msg_aggreg_gb=0.504,
        c_msg_train_gb=0.504,
        c_msg_test_gb=4e-6,
    )
    # Train comm 2 GB / test comm ~1 GB over the baseline pair took
    # (train_comm_bl + test_comm_bl) = 8.66 s total (§5.4).
    return FLApplication(
        name="til",
        clients=clients,
        messages=msgs,
        n_rounds=n_rounds,
        train_comm_bl=8.66 * (2.0 / 3.0),
        test_comm_bl=8.66 * (1.0 / 3.0),
        aggreg_bl=2.0,
        checkpoint_bytes=504 * 1024 * 1024,
    )


def til_application_aws(n_rounds: int = 10, n_clients: int = 2) -> FLApplication:
    """TIL for the AWS/GCP PoC testbed (§5.7): baselines re-probed against
    the g4dn.2xlarge (T4) baseline VM. The paper's on-demand PoC run took
    2:00:18 / $3.28 for 10 rounds with 2 clients (GPU-quota limited)."""
    clients = [
        ClientSpec(
            client_id=f"til_client_{i}",
            train_bl=680.0,   # seconds/round on the T4 baseline
            test_bl=12.0,
            n_train_samples=948,
            n_test_samples=522,
            silo_region="aws_us_east_1" if i == 0 else "gcp_us_central1",
        )
        for i in range(n_clients)
    ]
    msgs = MessageSizes(
        s_msg_train_gb=0.504,
        s_msg_aggreg_gb=0.504,
        c_msg_train_gb=0.504,
        c_msg_test_gb=4e-6,
    )
    return FLApplication(
        name="til_aws",
        clients=clients,
        messages=msgs,
        n_rounds=n_rounds,
        train_comm_bl=8.66 * (2.0 / 3.0),
        test_comm_bl=8.66 * (1.0 / 3.0),
        aggreg_bl=2.0,
        checkpoint_bytes=504 * 1024 * 1024,
    )


def shakespeare_application(n_rounds: int = 20) -> FLApplication:
    """LEAF Shakespeare adapted to Cross-Silo: 8 clients with 16488-26282
    train / 1833-2921 test samples; embedding-8 + 2x256 LSTM (§5.1).
    20 rounds x 20 epochs (§5.6.2). On-demand run: 1:53:54, $53.31."""
    sizes = [
        (16488, 1833), (17925, 1992), (19301, 2145), (20677, 2297),
        (22054, 2450), (23430, 2603), (24806, 2756), (26282, 2921),
    ]
    # Calibrated so that the on-demand all-vm_121-class run over 20 rounds
    # lands near the published 1:53:54 runtime.
    per_sample_train = 0.000236  # s/sample/epoch on baseline VM
    per_sample_test = 0.00030
    epochs = 20
    clients = [
        ClientSpec(
            client_id=f"shakespeare_client_{i}",
            train_bl=n_tr * per_sample_train * epochs,
            test_bl=n_te * per_sample_test,
            n_train_samples=n_tr,
            n_test_samples=n_te,
        )
        for i, (n_tr, n_te) in enumerate(sizes)
    ]
    # LSTM model is small (~3.3 MB): embeddings 8 + 2x256 LSTM.
    msgs = MessageSizes.from_model_bytes(3_300_000)
    return FLApplication(
        name="shakespeare",
        clients=clients,
        messages=msgs,
        n_rounds=n_rounds,
        train_comm_bl=0.30,
        test_comm_bl=0.15,
        aggreg_bl=0.5,
        epochs_per_round=epochs,
        checkpoint_bytes=3_300_000,
    )


def femnist_application(n_rounds: int = 100) -> FLApplication:
    """LEAF FEMNIST adapted to Cross-Silo: 5 clients, 796-1050 train /
    90-118 test samples (doubled datasets), 2 conv + 10x4096 FC layers.
    100 rounds x 100 epochs (§5.6.2). On-demand run: 1:56:37, $35.68."""
    sizes = [(796, 90), (860, 97), (924, 104), (988, 111), (1050, 118)]
    per_sample_train = 0.000132
    per_sample_test = 0.00020
    epochs = 100
    clients = [
        ClientSpec(
            client_id=f"femnist_client_{i}",
            train_bl=n_tr * per_sample_train * epochs,
            test_bl=n_te * per_sample_test,
            n_train_samples=n_tr,
            n_test_samples=n_te,
        )
        for i, (n_tr, n_te) in enumerate(sizes)
    ]
    # 2 conv + 10 FC layers of 4096 neurons: ~170M params fp32 ≈ 680 MB is too
    # big for LEAF's runtime; the paper reports smaller exchange volumes —
    # we model the 10x4096 MLP tower at ~170 MB (fp32, tied estimate).
    msgs = MessageSizes.from_model_bytes(170_000_000)
    return FLApplication(
        name="femnist",
        clients=clients,
        messages=msgs,
        n_rounds=n_rounds,
        train_comm_bl=0.70,
        test_comm_bl=0.35,
        aggreg_bl=0.5,
        epochs_per_round=epochs,
        checkpoint_bytes=170_000_000,
    )
