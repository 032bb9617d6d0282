"""A closed-loop HTTP load generator, run in a child process so that it
shares no interpreter lock with the server it loads.

The child receives the request bodies and its number of clients, waits
for ``"go"``, then runs the clients, each a thread that sends the next
request of the list as soon as its last reply has come, one connection a
request. The list is shared and taken in order. With a window, clients
send until it closes, the list wrapped round if the window outlasts it;
the replies in flight are awaited. Without one, each request is sent
once. So the rate completed is the server's own: no offered rate caps it.
Each result holds the request's index, its status and, from ``go``, when
it was sent and when its last byte came. The replies' bodies stay in the
child until the parent names the ones it wants. Only the standard library
is imported here.
"""

from __future__ import annotations

import http.client
import pickle
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple


def _post(host: str, port: int, body: bytes) -> Tuple[int, bytes, str]:
    try:
        conn = http.client.HTTPConnection(host, port, timeout=120)
        try:
            conn.request("POST", "/render", body,
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp.status, resp.read(), ""
        finally:
            conn.close()
    except OSError as e:
        return 0, b"", str(e)


def run_clients(host: str, port: int, bodies: Sequence[bytes], clients: int,
                seconds: Optional[float]
                ) -> Tuple[List[dict], Dict[int, bytes]]:
    """Run ``clients`` closed-loop clients over ``bodies`` from now on:
    until ``seconds`` have passed, or, with ``seconds`` None, until each
    body has been sent once. Returns the results in the order sent and
    each reply's body by index."""
    t0 = time.perf_counter()
    guard = threading.Lock()
    nxt = [0]
    results, replies = [], {}

    def client():
        while True:
            with guard:
                i = nxt[0]
                if (seconds is None and i >= len(bodies)) or \
                        (seconds is not None
                         and time.perf_counter() - t0 >= seconds):
                    return
                nxt[0] += 1
            sent = time.perf_counter() - t0
            status, data, error = _post(host, port, bodies[i % len(bodies)])
            done = time.perf_counter() - t0
            with guard:
                results.append({"index": i, "status": status,
                                "sent_s": sent, "done_s": done,
                                "error": error})
                replies[i] = data

    threads = [threading.Thread(target=client) for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    results.sort(key=lambda r: r["index"])
    return results, replies


def main() -> None:
    """The child's entry (``python -m portbench.harness.loadgen``): read
    the job from standard input, say ``ready``, wait for ``go``, run and
    write the results; then read the indices whose bodies are wanted and
    write those. Everything is pickled, by the parent's
    :class:`portbench.kinds.serve.LoadGen` and this function alone."""
    stdin, stdout = sys.stdin.buffer, sys.stdout.buffer
    host, port, bodies, clients, seconds = pickle.load(stdin)
    stdout.write(b"ready\n")
    stdout.flush()
    if stdin.readline().strip() != b"go":
        return
    results, replies = run_clients(host, port, bodies, clients, seconds)
    pickle.dump(results, stdout)
    stdout.flush()
    want = pickle.load(stdin)
    pickle.dump({i: replies[i] for i in want}, stdout)
    stdout.flush()


if __name__ == "__main__":
    main()
