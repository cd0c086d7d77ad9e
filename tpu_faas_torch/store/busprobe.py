"""How fast a burst of task announces crosses the store bus to one
subscriber.

Writes 20,000 records with ``create_tasks`` on one channel, in batches
of ``--chunk``, through the port's store server (in this process,
or with ``--process`` in a child process of its own), and drains the
announces off one subscription: after each batch, or with ``--late`` only
once every batch is written. Prints how many arrived, when the count
passed each mark, and the total time; gives up after 40 seconds.

``--variant`` changes one side of the bus at a time, to find which side
holds the bytes of a burst that stalls:

- ``client``: the subscription of ``store/client.py`` (the default);
- ``raw``: a raw socket that sends one SUBSCRIBE and counts frames off
  ``recv(1 << 20)``, in place of the client's subscriber;
- ``raw-rcvbuf``: the raw socket with an 8 MiB ``SO_RCVBUF`` set before
  it connects;
- ``sndbuf``: the client's subscriber; the server sets an 8 MiB
  ``SO_SNDBUF`` on each subscriber's socket before it writes to it;
- ``concurrent``: the client's subscriber read on a thread of its own
  while the batches are written;
- ``drain``: as ``concurrent``, and the server awaits ``writer.drain()``
  after every 256 frames it writes to a subscriber.

``--sweep`` runs every variant at ``--chunk`` and ``client`` at 1,000,
one line each, within ``--limit`` seconds each.

    python -m tpu_faas_torch.store.busprobe --late
    python -m tpu_faas_torch.store.busprobe --chunk 1000
    python -m tpu_faas_torch.store.busprobe --sweep --limit 20
"""

from __future__ import annotations

import argparse
import contextlib
import socket
import subprocess
import sys
import threading
import time

from tpu_faas_torch.store import resp
from tpu_faas_torch.store.client import SUBSCRIBER_RCVBUF, _Conn
from tpu_faas_torch.store.launch import make_store, start_store_thread
from tpu_faas_torch.store.server import StoreServer

MARKS = (1_000, 1_500, 1_600, 2_000, 5_000, 10_000)
TASKS, LIMIT_S = 20_000, 40.0
VARIANTS = ("client", "raw", "raw-rcvbuf", "sndbuf", "concurrent", "drain")
DRAIN_EVERY = 256


class _RawSub:
    """One SUBSCRIBE on a connected socket; frames counted off
    recv(1 << 20)."""

    def __init__(self, sock: socket.socket, channel: str) -> None:
        self.sock = sock
        self.sock.settimeout(None)
        self.sock.sendall(resp.encode_command("SUBSCRIBE", channel))
        self.parser = resp.RespParser()
        self.pending = 0
        # the confirmation first: announces published before the server
        # registered the subscription are not delivered
        item = resp.NEED_MORE
        while item is resp.NEED_MORE:
            self.parser.feed(self.sock.recv(1 << 20))
            item = self.parser.pop()
        if not (isinstance(item, list) and item[0] == "subscribe"):
            raise ConnectionError(f"unexpected SUBSCRIBE reply: {item!r}")

    def get_message(self, timeout: float) -> str | None:
        while self.pending == 0:
            self.sock.settimeout(timeout)
            try:
                data = self.sock.recv(1 << 20)
            except socket.timeout:
                return None
            if not data:
                raise ConnectionError("subscription closed")
            self.parser.feed(data)
            item = self.parser.pop()
            while item is not resp.NEED_MORE:
                if isinstance(item, list) and item and item[0] == "message":
                    self.pending += 1
                item = self.parser.pop()
        self.pending -= 1
        return "message"

    def close(self) -> None:
        self.sock.close()


@contextlib.contextmanager
def server_side(variant: str):
    """Patch the in-process server's ``_publish`` for the ``sndbuf`` and
    ``drain`` variants; a no-op for the others."""
    if variant not in ("sndbuf", "drain"):
        yield
        return
    original = StoreServer._publish
    written: dict = {}

    async def publish(self, channel: str, payload: str) -> int:
        receivers = list(self.state.subs.get(channel, ()))
        if variant == "sndbuf":
            for w in receivers:
                if w not in written:
                    written[w] = 0
                    w.get_extra_info("socket").setsockopt(
                        socket.SOL_SOCKET, socket.SO_SNDBUF,
                        SUBSCRIBER_RCVBUF)
        n = await original(self, channel, payload)
        if variant == "drain":
            for w in receivers:
                written[w] = written.get(w, 0) + 1
                if written[w] % DRAIN_EVERY == 0 and not w.is_closing():
                    await w.drain()
        return n

    StoreServer._publish = publish
    try:
        yield
    finally:
        StoreServer._publish = original


def probe(url: str, tasks: int, chunk: int, late: bool, limit: float,
          variant: str = "client") -> str:
    feeder = make_store(url)
    watcher = None
    if variant.startswith("raw"):
        host, port = url.split("//", 1)[1].rsplit(":", 1)
        sock = (
            _Conn(host, int(port), subscriber=True).sock
            if variant == "raw-rcvbuf"
            else socket.create_connection((host, int(port)))
        )
        sub = _RawSub(sock, "busprobe")
    else:
        watcher = make_store(url)
        sub = watcher.subscribe("busprobe")
    got, marks = 0, []
    t0 = time.perf_counter()

    def drain(goal: int) -> None:
        nonlocal got
        while got < goal and time.perf_counter() - t0 < limit:
            if sub.get_message(timeout=0.005) is None:
                continue
            got += 1
            if got in MARKS or got == tasks:
                marks.append((got, round(time.perf_counter() - t0, 3)))

    reader = None
    if variant in ("concurrent", "drain"):
        reader = threading.Thread(target=drain, args=(tasks,), daemon=True)
        reader.start()
    try:
        for lo in range(0, tasks, chunk):
            hi = min(lo + chunk, tasks)
            feeder.create_tasks([(f"probe-{i}", "F", "P")
                                 for i in range(lo, hi)], "busprobe")
            if not late and reader is None:
                drain(hi)
        if reader is None:
            drain(tasks)
        else:
            reader.join(timeout=limit + 5.0)
    finally:
        sub.close()
        feeder.close()
        if watcher is not None:
            watcher.close()
    took = time.perf_counter() - t0
    how = ("while they are written" if reader is not None
           else "after the last" if late else "after each")
    return (f"{got} of {tasks} announces in {took:.3f} s, "
            f"written in batches of {chunk} and drained {how}; count at "
            f"seconds {marks}")


def run_in_thread(tasks: int, chunk: int, late: bool, limit: float,
                  variant: str) -> str:
    with server_side(variant):
        handle = start_store_thread()
        try:
            return probe(handle.url, tasks, chunk, late, limit, variant)
        finally:
            handle.stop()


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chunk", type=int, default=2_000)
    ap.add_argument("--late", action="store_true")
    ap.add_argument("--process", action="store_true",
                    help="run the store server in a child process")
    ap.add_argument("--port", type=int, default=6411)
    ap.add_argument("--variant", choices=VARIANTS, default="client")
    ap.add_argument("--sweep", action="store_true",
                    help="every variant at --chunk, then client at 1,000")
    ap.add_argument("--limit", type=float, default=LIMIT_S)
    args = ap.parse_args(argv)
    if args.sweep:
        runs = [(v, args.chunk) for v in VARIANTS] + [("client", 1_000)]
        for variant, chunk in runs:
            line = run_in_thread(TASKS, chunk, args.late, args.limit, variant)
            print(f"[{variant}] {line}", flush=True)
        return
    if not args.process:
        print(run_in_thread(TASKS, args.chunk, args.late, args.limit,
                            args.variant), flush=True)
        return
    if args.variant in ("sndbuf", "drain"):
        sys.exit("--process runs the server unpatched: client, raw, "
                 "raw-rcvbuf or concurrent")
    url = f"resp://127.0.0.1:{args.port}"
    child = subprocess.Popen(
        [sys.executable, "-m", "tpu_faas_torch.store.server", "--port",
         str(args.port)], stdout=subprocess.DEVNULL)
    try:
        for _ in range(300):  # the child imports, then binds
            try:
                make_store(url).close()
                break
            except OSError:
                time.sleep(0.1)
        print(probe(url, TASKS, args.chunk, args.late, args.limit,
                    args.variant), flush=True)
    finally:
        child.kill()
        child.wait()


if __name__ == "__main__":
    main()
