"""The port's ``util`` host helpers against the JAX package's, on the CPU.

``get_ip_address`` reads the interface of the default route from the
routing table where the JAX package's version asks the kernel for the
route of a UDP socket; on one host both must name the same address, and
neither may advertise the loopback address a hostname often resolves to.
"""

import socket

import pytest
import torch

from tensorflowonspark_tpu import util as jax_util
from tensorflowonspark_tpu_torch import util

HEADER = "Iface\tDestination\tGateway\tFlags\tRefCnt\tUse\tMetric\tMask\tMTU\tWindow\tIRTT\n"


def _route_table(tmp_path, rows):
    path = tmp_path / "route"
    path.write_text(HEADER + "".join("\t".join(r) + "\n" for r in rows))
    return str(path)


def test_ip_address_matches_reference():
    assert util.get_ip_address() == jax_util.get_ip_address()


@pytest.mark.parametrize("rows, want", [
    ([], None),
    # a default route (destination and mask 0, flags UP|GATEWAY)
    ([("eth0", "00000000", "010200C0", "0003", "0", "0", "0", "00000000", "0", "0", "0")], "eth0"),
    # the lowest metric wins; a route that is down and a subnet route do not count
    ([("eth0", "00000000", "010200C0", "0003", "0", "0", "100", "00000000", "0", "0", "0"),
      ("eth1", "00000000", "010300C0", "0003", "0", "0", "10", "00000000", "0", "0", "0"),
      ("eth2", "00000000", "010400C0", "0002", "0", "0", "0", "00000000", "0", "0", "0"),
      ("eth3", "000200C0", "00000000", "0001", "0", "0", "0", "00FFFFFF", "0", "0", "0")], "eth1"),
])
def test_default_route_interface(tmp_path, rows, want):
    assert util._default_route_interface(_route_table(tmp_path, rows)) == want


def test_default_route_interface_without_a_table(tmp_path):
    assert util._default_route_interface(str(tmp_path / "absent")) is None


def test_interface_address_of_loopback():
    assert util._interface_address("lo") == "127.0.0.1"


def test_ip_address_prefers_the_routed_interface_over_a_loopback_hostname(monkeypatch):
    """A Debian-style ``/etc/hosts`` maps the hostname to 127.0.1.1; the
    address other hosts can reach is the routed interface's."""
    monkeypatch.setattr(socket, "gethostbyname", lambda _name: "127.0.1.1")
    monkeypatch.setattr(util, "_default_route_interface", lambda: "eth7")
    monkeypatch.setattr(util, "_interface_address", lambda name: {"eth7": "10.1.2.3"}[name])
    assert util.get_ip_address() == "10.1.2.3"


def test_ip_address_falls_back_to_the_hostname(monkeypatch):
    def no_address(_name):
        raise OSError("no address")

    monkeypatch.setattr(socket, "gethostbyname", lambda _name: "10.9.8.7")
    monkeypatch.setattr(util, "_default_route_interface", lambda: "eth7")
    monkeypatch.setattr(util, "_interface_address", no_address)
    assert util.get_ip_address() == "10.9.8.7"
    monkeypatch.setattr(util, "_default_route_interface", lambda: None)
    assert util.get_ip_address() == "10.9.8.7"


def test_ip_address_aims_no_socket_anywhere(monkeypatch):
    class NoConnect(socket.socket):
        def connect(self, address):
            raise AssertionError("connect({}) called".format(address))

    monkeypatch.setattr(socket, "socket", NoConnect)
    ip = util.get_ip_address()
    assert isinstance(ip, str) and ip.count(".") == 3


def test_select_device_gpu_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        util.select_device("gpu")
    assert util.select_device("cpu") == torch.device("cpu")


def test_cpu_share_splits_the_usable_cores(monkeypatch):
    """A CPU trainer's intra-op threads: its share of the cores it may run
    on, at least one (C13: each child taking all of them oversubscribed
    the host)."""
    monkeypatch.setattr(util.os, "sched_getaffinity", lambda pid: set(range(8)), raising=False)
    assert [util.cpu_share(n) for n in (1, 2, 3, 8, 16, 0)] == [8, 4, 2, 1, 1, 8]


def test_nodes_on_host_counts_the_cluster_spec_by_host():
    from tensorflowonspark_tpu_torch.TFSparkNode import TFNodeContext, _nodes_on_host

    spec = {"chief": ["a:1"], "worker": ["a:2", "b:1", "a:3"], "ps": ["b:2"]}
    ctx = lambda job, i: TFNodeContext(0, job, i, spec, "file://", ".")  # noqa: E731
    assert _nodes_on_host(ctx("worker", 0)) == 3 and _nodes_on_host(ctx("ps", 0)) == 2
    assert _nodes_on_host(TFNodeContext(0, "worker", 0, None, "file://", ".")) == 1
