"""The port's ZMQ daemons (mods_tpu_torch/serve/zmq_server.py) against
the JAX package's (mods_tpu/serve/zmq_server.py), on the CPU.

The handlers' replies to the same PNG request agree within the CNN
tolerances of PERF.md §2 (HardNet 1e-2 on 0..255, AffNet 1e-4, OriNet's
angle 1e-3 rad); HardNet at weights/HardNetPS.npz, AffNet and OriNet at
the seeded random weights both packages make under the opt-in.  Then a
real round trip over localhost sockets (free ports, found at run time),
the client's timeout on a port nobody serves, and serve_all raising for
a daemon that does not start."""
import threading

import cv2
import numpy as np
import pytest

zmq = pytest.importorskip("zmq")

from mods_tpu.config import Config as JConfig
from mods_tpu.serve import zmq_server as jserver
from mods_tpu_torch.config import Config
from mods_tpu_torch.desc import cnn
from mods_tpu_torch.serve import zmq_server as tserver
from torch_parity_helpers import free_ports
from torch_parity_helpers import one_torch_thread  # noqa: F401  (autouse)

HARDNET = str(cnn.DEFAULT_WEIGHTS["hardnet"])


@pytest.fixture
def random_opt_in(monkeypatch):
    monkeypatch.setenv(cnn.RANDOM_OPT_IN, "1")


def _configs():
    jcfg, tcfg = JConfig(), Config()
    jcfg.hardnet.weights = tcfg.hardnet.weights = HARDNET
    return jcfg, tcfg


def _request(n, seed):
    patches = np.random.default_rng(seed).uniform(0, 255, (n, 32, 32))
    ok, png = cv2.imencode(".png", patches.reshape(n * 32, 32).astype(np.uint8))
    assert ok
    return png.tobytes()


@pytest.mark.parametrize("which,dim", [("hardnet", 128), ("affnet", 3), ("orinet", 2)])
def test_handler_replies_match_jax(which, dim, random_opt_in):
    jcfg, tcfg = _configs()
    msg = _request(37, 1)
    want = np.frombuffer(jserver._make_handler(which, jcfg)(msg), np.float32).reshape(37, dim)
    got = np.frombuffer(tserver._make_handler(which, tcfg, "cpu")(msg), np.float32)
    got = got.reshape(37, dim)
    if which == "orinet":
        da = np.angle(np.exp(1j * (np.arctan2(got[:, 0], got[:, 1])
                                   - np.arctan2(want[:, 0], want[:, 1]))))
        assert np.abs(da).max() <= 1e-3
    else:
        np.testing.assert_allclose(got, want, atol=1e-2 if which == "hardnet" else 1e-4,
                                   rtol=0)
    if which == "hardnet":
        assert 0.0 <= got.min() and got.max() <= 255.0 and got.std() > 1.0


def test_requests_that_do_not_decode_get_an_empty_reply():
    _, tcfg = _configs()
    handle = tserver._make_handler("hardnet", tcfg, "cpu")
    assert handle(b"not a png") == b""
    ok, png = cv2.imencode(".png", np.zeros((50, 32), np.uint8))   # 50 % 32 != 0
    assert handle(png.tobytes()) == b""


def test_socket_round_trip_and_dead_port(random_opt_in):
    """The three heads as threads on localhost ports; each reply equals
    the net's own forward of the decoded patches; a stopped daemon's
    thread ends; the client raises when no daemon answers."""
    _, tcfg = _configs()
    stop = threading.Event()
    *ports, dead = free_ports(4)
    threads = tserver.serve_all(tcfg, ports, stop, device="cpu")
    try:
        rng = np.random.default_rng(2)
        for (which, port), n in zip(zip(tserver.HEADS, ports), (9, 5, 1)):
            patches = np.round(rng.uniform(0, 255, (n, 32, 32))).astype(np.float32)
            out = tserver.query(patches, port=port, timeout_s=30.0)
            net = cnn.get_net(tcfg, which, "cpu")
            direct = np.frombuffer(tserver.describe_patches(net, patches), np.float32)
            assert out.shape == (n, net.out_dim)
            np.testing.assert_array_equal(out.ravel(), direct)
    finally:
        stop.set()
        for th in threads:
            th.join(10)
    assert not any(th.is_alive() for th in threads)
    with pytest.raises(zmq.error.Again):
        tserver.query(np.zeros((1, 32, 32), np.float32), port=dead, timeout_s=0.3)
    with pytest.raises(ValueError):
        tserver.query(np.zeros((1, 32, 16), np.float32), port=ports[0])


def test_serve_all_raises_for_a_daemon_that_does_not_start(monkeypatch, tmp_path):
    """AffNet at a weight file that is not there, without the random
    opt-in, cannot load: the HardNet daemon before it stops and serve_all
    raises from the net's error; a port another socket holds raises from
    the bind."""
    _, tcfg = _configs()
    tcfg.affnet.weights = str(tmp_path / "AffNet.pth")
    monkeypatch.delenv(cnn.RANDOM_OPT_IN, raising=False)
    ports = free_ports(3)
    stop = threading.Event()
    with pytest.raises(RuntimeError, match="affnet daemon did not start") as e:
        tserver.serve_all(tcfg, ports, stop, device="cpu")
    assert isinstance(e.value.__cause__, FileNotFoundError) and stop.is_set()
    taken = zmq.Context.instance().socket(zmq.REP)
    try:
        port = taken.bind_to_random_port("tcp://*")
        with pytest.raises(RuntimeError, match="hardnet daemon did not start") as e:
            tserver.serve_all(tcfg, [port, *ports[1:]], device="cpu")
        assert isinstance(e.value.__cause__, zmq.error.ZMQError)
    finally:
        taken.close(0)
