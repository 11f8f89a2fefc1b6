"""Real-wire party runtime: transports + multi-process MPC execution —
the port of `repro.net`.

`mpc/comm.py` captures each online flight's actual messages into a
WireTape; this package replays the tape as real parties — threads over
in-process queues (`LocalTransport`) or spawned processes over paced
localhost TCP (`SocketTransport`) — reconciling transport-counted bytes
against the ledger and measuring wall-clock (`wire_makespan_s`).

Chaos hardening: `net.faults.FaultPlan` injects seeded, deterministic
failures (drops, latency spikes, connection resets, party crashes) and
`ReliableTransport` + the supervisor in `runtime.py` recover them —
goodput still reconciles byte-for-byte and digests stay bitwise equal.

The package imports neither torch nor anything of the port that does
(a tape is duck-typed: `flights`, `n_parties`, `link_frames()`), so a
spawned socket party imports sockets, threads and numpy only.
"""
from repro_torch.net.transport import (          # noqa: F401
    ACK,
    BEAT,
    DATA,
    SYNC,
    LocalTransport,
    ReliableTransport,
    SocketTransport,
    TokenBucket,
    Transport,
    WireDown,
    WireError,
    free_ports,
)
from repro_torch.net.runtime import (            # noqa: F401
    PartyRuntime,
    WireReport,
    compile_plan,
    expected_digests,
    filter_tape,
    reconcile,
)
from repro_torch.net.faults import (             # noqa: F401
    ChaosTransport,
    FaultPlan,
    InjectedCrash,
)
