"""The async pod's coordinator on the wire: what one peer does to the
others (``runtime/coordinator.py``).

The accept loop accepts raw connections and each connection runs the
authkey handshake on its own thread with a deadline, so:

  * a peer that connects and closes mid-handshake is dropped alone: the
    loop keeps serving and a worker then joins;
  * a peer that connects and never speaks delays no other worker's join,
    and is dropped by the server within its handshake deadline;
  * a worker whose peer accepts and stays silent raises
    ``CoordinatorUnavailable`` by its deadline (its connect and its
    handshake are bounded by it);
  * a pod's ports are drawn in one call (``free_ports``): distinct, free,
    and outside the kernel's ephemeral range, from which a worker's
    retry could otherwise take one as its source port (a TCP self-connect)
    before its coordinator binds it.

Each case runs on the CPU in a few seconds.
"""
import socket
import time

import pytest

from repro_torch.runtime import Coordinator, CoordinatorClient
from repro_torch.runtime import coordinator
from repro_torch.runtime.coordinator import (CoordinatorUnavailable,
                                             connect, ephemeral_range,
                                             free_ports)
from torch_parity import one_torch_thread  # noqa: F401

# the handshake deadline in these cases
HANDSHAKE_S = 0.5


@pytest.fixture(autouse=True)
def short_handshake(monkeypatch):
    monkeypatch.setattr(coordinator, "HANDSHAKE_S", HANDSHAKE_S)


def _join_seconds(port) -> float:
    t0 = time.monotonic()
    c = CoordinatorClient(port, "w0", retry_s=5.0, heartbeat_s=0)
    try:
        reply = c.join()
        assert reply["n_active"] == 1
    finally:
        c.leave()
    return time.monotonic() - t0


@pytest.mark.parametrize("when", ["before_challenge", "after_challenge"])
def test_peer_closing_mid_handshake_leaves_the_loop_serving(when):
    """A peer that connects and closes (before or after reading the
    server's challenge) ends only its own connection: the accept loop
    is still alive and a worker then joins."""
    coord = Coordinator(0)
    port = coord._listener.address[1]
    try:
        for _ in range(3):
            s = socket.create_connection(("127.0.0.1", port))
            if when == "after_challenge":
                s.settimeout(2.0)
                assert s.recv(4096)          # the challenge's bytes
            s.close()
        time.sleep(0.1)
        assert coord._accept_thread.is_alive()
        assert _join_seconds(port) < 2.0
        assert coord._accept_thread.is_alive()
    finally:
        coord.close()


def test_silent_peer_delays_no_join():
    """A peer that connects and never speaks holds up no other worker:
    the join takes well under the handshake deadline, and the server
    drops the silent peer once the deadline passes."""
    coord = Coordinator(0)
    port = coord._listener.address[1]
    silent = socket.create_connection(("127.0.0.1", port))
    try:
        assert _join_seconds(port) < HANDSHAKE_S
        silent.settimeout(HANDSHAKE_S + 2.0)
        t0 = time.monotonic()
        while silent.recv(4096):             # the challenge, then EOF
            pass
        assert time.monotonic() - t0 <= HANDSHAKE_S + 1.0
    finally:
        silent.close()
        coord.close()


def test_worker_raises_by_its_deadline_against_a_silent_server():
    """A socket that accepts (its backlog does) and never speaks: the
    worker's connect and handshake are bounded by its retry deadline,
    after which it raises ``CoordinatorUnavailable``."""
    server = socket.socket()
    server.bind(("127.0.0.1", 0))
    server.listen(8)
    port = server.getsockname()[1]
    try:
        t0 = time.monotonic()
        with pytest.raises(CoordinatorUnavailable):
            CoordinatorClient(port, "w0", retry_s=1.0, heartbeat_s=0)
        assert time.monotonic() - t0 < 1.0 + 1.5
        t0 = time.monotonic()
        with pytest.raises(OSError):
            connect(port, time.monotonic() + 0.3)
        assert time.monotonic() - t0 < 0.3 + 1.0
    finally:
        server.close()


def test_two_pods_ports_never_share_one():
    """Two pods' ports and their coordinators' (four ports, drawn in one
    call) are distinct, each free to bind, and outside the ephemeral
    range, for many draws."""
    lo, hi = ephemeral_range()
    for _ in range(50):
        ports = free_ports(4)
        assert len(set(ports)) == 4
        assert all(not lo <= p <= hi and 1024 <= p < 65536 for p in ports)
    for p in free_ports(4):
        with socket.socket() as s:
            s.bind(("127.0.0.1", p))
