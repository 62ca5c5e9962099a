"""ZeroMQ inference daemons on the card, wire-compatible with the
reference's GPU servers (build/desc_server.py, affnet_server.py,
orinet_server.py).

Counterpart of the JAX package's serve/zmq_server.py.  Protocol
(reference desc_server.py:104-128):
  request : PNG-encoded uint8 column image of N stacked w x w patches
  reply   : raw float32 buffer [N, out_dim]

The reference binds one PyTorch daemon per port (5555 desc / 5556 affnet
/ 5557 orinet); here the port's three nets (desc/cnn.py: HardNet, AffNet,
OriNet, in f32 with TF32 off) serve inside one process, one REP socket
and one thread per port, on one device.  A request goes through the net
in chunks of cnn.CHUNK patches; the nets run in eval mode, so each row is
independent of the others and no padding is needed.

Run:  python -m mods_tpu_torch.serve.zmq_server [--ports 5555,5556,5557]
          [--config config.ini] [--device cuda|cpu]
Test: any reference-compatible client, or `query()` below.
"""
from __future__ import annotations

import argparse
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..config import Config, load_config
from ..desc import cnn

HEADS = ("hardnet", "affnet", "orinet")


def decode_patches(message: bytes) -> Optional[np.ndarray]:
    """A request's PNG column image -> [N, w, w] float32 patches, or None
    when it does not decode to a column of square patches."""
    import cv2
    img = cv2.imdecode(np.frombuffer(message, np.uint8), cv2.IMREAD_GRAYSCALE)
    if img is None or img.shape[0] % img.shape[1]:
        return None
    h, w = img.shape
    return img.reshape(h // w, w, w).astype(np.float32)


def describe_patches(net: cnn._Net, patches: np.ndarray) -> bytes:
    """[N, w, w] patches -> the reply: the net's [N, out_dim] float32 rows
    as raw bytes, forwarded on the net's device."""
    dev = next(net.buffers()).device
    x = torch.from_numpy(np.ascontiguousarray(patches, np.float32)).to(dev)
    out = cnn.forward_rows(net, x, net.out_dim)
    return np.ascontiguousarray(out.cpu().numpy(), np.float32).tobytes()


def _make_handler(which: str, cfg: Config, device=None) -> Callable[[bytes], bytes]:
    """fn(png_bytes) -> float32 reply bytes for one head, on `device` (the
    card unless the caller asks for the CPU)."""
    net = cnn.get_net(cfg, which, device)

    def handle(message: bytes) -> bytes:
        patches = decode_patches(message)
        if patches is None:
            return np.zeros(0, np.float32).tobytes()
        t0 = time.perf_counter()
        reply = describe_patches(net, patches)
        dt = time.perf_counter() - t0
        n = len(patches)
        print(f"[{which}] {n} patches in {dt:.4f}s "
              f"({dt / max(n, 1):.2e} s/patch)", flush=True)
        return reply

    return handle


def serve_one(which: str, port: int, cfg: Config,
              stop: Optional[threading.Event] = None,
              bound: Optional[threading.Event] = None, device=None) -> None:
    """REP loop for one head (reference desc_server.py:121-128) until
    `stop` is set; `bound` is set once the socket listens."""
    import zmq
    handler = _make_handler(which, cfg, device)
    sock = zmq.Context.instance().socket(zmq.REP)
    try:
        sock.bind(f"tcp://*:{port}")
        if bound is not None:
            bound.set()
        poller = zmq.Poller()
        poller.register(sock, zmq.POLLIN)
        print(f"[{which}] serving on tcp://*:{port}", flush=True)
        while stop is None or not stop.is_set():
            if not poller.poll(200):
                continue
            sock.send(handler(sock.recv()))
    finally:
        sock.close(0)


def serve_all(cfg: Config, ports=(5555, 5556, 5557),
              stop: Optional[threading.Event] = None, device=None,
              timeout_s: float = 60.0) -> list:
    """The three daemons (reference build/run_zmq_servers.sh) as threads
    of this process; returns the threads once each listens.  A daemon that
    fails to start (its net does not load, its port is taken) or does not
    listen within `timeout_s` raises RuntimeError here, from its error;
    the daemons started before it then stop."""
    stop = threading.Event() if stop is None else stop
    threads = []
    for which, port in zip(HEADS, ports):
        ready, failed = threading.Event(), []

        def run(which=which, port=port, ready=ready, failed=failed):
            try:
                serve_one(which, port, cfg, stop, ready, device)
            except BaseException as e:
                failed.append(e)
                ready.set()

        th = threading.Thread(target=run, daemon=True)
        th.start()
        if not ready.wait(timeout=timeout_s) or failed:
            stop.set()
            raise RuntimeError(f"the {which} daemon did not start on port {port}"
                               + ("" if failed else f" within {timeout_s} s")) \
                from (failed[0] if failed else None)
        threads.append(th)
    return threads


def query(patches: np.ndarray, port: int = 5555, addr: str = "tcp://localhost",
          timeout_s: float = 30.0) -> np.ndarray:
    """Client side (reference DescribeWithZmq, imagerepresentation.cpp:21-103):
    stack patches into a column image, PNG-encode, REQ round-trip, split
    the float32 reply.  Unlike the reference (a blocking recv forever if
    the daemon is down), a timeout raises zmq.error.Again."""
    import cv2
    import zmq
    n, h, w = patches.shape
    if h != w:
        raise ValueError(f"patches must be square, got {h}x{w}")
    col = np.clip(patches.reshape(n * h, w), 0, 255).astype(np.uint8)
    ok, png = cv2.imencode(".png", col)
    if not ok:
        raise ValueError("PNG encoding failed")
    sock = zmq.Context.instance().socket(zmq.REQ)
    sock.setsockopt(zmq.RCVTIMEO, int(timeout_s * 1000))
    sock.setsockopt(zmq.SNDTIMEO, int(timeout_s * 1000))
    sock.setsockopt(zmq.LINGER, 0)
    sock.connect(f"{addr}:{port}")
    try:
        sock.send(png.tobytes())
        reply = sock.recv()
    finally:
        sock.close(0)
    out = np.frombuffer(reply, np.float32)
    return out.reshape(n, -1) if n else out.reshape(0, 0)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ports", default="5555,5556,5557")
    p.add_argument("--config", default=None)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    cfg = load_config(args.config) if args.config else Config()
    serve_all(cfg, [int(x) for x in args.ports.split(",")], device=args.device)
    while True:
        time.sleep(3600)


if __name__ == "__main__":
    main()
