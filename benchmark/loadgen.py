"""Open-loop HTTP load: a process of its own, one thread, the standard library.

    python3 benchmark/loadgen.py   (driven by ``drivers/rest_open_loop.py``)

Reads one JSON line from stdin: ``{"port", "timeout_s", "warm": [[due, body],
...], "window": [[due, body], ...]}``, ``due`` in seconds from the phase's
start, ``body`` the JSON text of a predict request. It sends the warm
requests and waits for them, prints ``warm_done``, waits for a ``go`` line,
then sends the window's. Each request is sent when it is due, whether or not
earlier ones have been answered, on a connection of its own, and is timed
from when it was due to its parsed answer. A request that gets no answer
within ``timeout_s`` of its due time fails. The last line of stdout is the
window's result: ``{"requests": [[due, sent, done, status, items], ...]}``
(seconds from the window's start; ``items`` is the answer's item rows, or
null when it failed).
"""
import asyncio
import gc
import json
import sys
import time

PATH = "/v1/models/lightgcn_recommender:predict"
SPIN_S = 0.0015


async def _request(port: int, body: bytes, deadline: float):
    reader, writer = await asyncio.wait_for(asyncio.open_connection("127.0.0.1", port),
                                            max(0.0, deadline - time.monotonic()))
    try:
        writer.write(b"POST %s HTTP/1.1\r\nHost: 127.0.0.1\r\nContent-Type: application/json\r\n"
                     b"Content-Length: %d\r\nConnection: close\r\n\r\n%s" % (PATH.encode(), len(body), body))
        await writer.drain()
        data = await asyncio.wait_for(reader.read(), max(0.0, deadline - time.monotonic()))
    finally:
        writer.close()
    head, _, payload = data.partition(b"\r\n\r\n")
    status = int(head.split(b" ", 2)[1])
    return status, (json.loads(payload)["items"] if status == 200 else None)


async def _phase(port: int, schedule, timeout_s: float):
    t0 = time.monotonic()
    out = [None] * len(schedule)

    async def one(k, due, body):
        sent = time.monotonic() - t0
        try:
            status, items = await _request(port, body, t0 + due + timeout_s)
        except (OSError, asyncio.TimeoutError, ValueError, IndexError) as e:
            status, items = 0, None
            print(f"request {k} failed: {type(e).__name__}: {e}", file=sys.stderr, flush=True)
        out[k] = [due, sent, time.monotonic() - t0, status, items]

    tasks = []
    for k, (due, body) in enumerate(schedule):
        # The loop's sleep wakes up to a millisecond late (the selector's
        # timeout is in whole milliseconds): sleep to just short of the due
        # time, then yield to the loop until it comes.
        delay = t0 + due - time.monotonic()
        if delay > SPIN_S:
            await asyncio.sleep(delay - SPIN_S)
        while time.monotonic() < t0 + due:
            await asyncio.sleep(0)
        tasks.append(asyncio.create_task(one(k, due, body.encode())))
    await asyncio.gather(*tasks)
    return out


def main() -> int:
    # The answers are kept until the end: a collection pass over them would
    # stall the sender (the process is short-lived; nothing needs freeing).
    gc.disable()
    cfg = json.loads(sys.stdin.readline())
    warm = asyncio.run(_phase(cfg["port"], cfg["warm"], cfg["timeout_s"]))
    failed = sum(1 for r in warm if r[3] != 200)
    print(json.dumps({"warm_done": len(warm), "warm_failed": failed}), flush=True)
    if sys.stdin.readline().strip() != "go":
        return 1
    out = asyncio.run(_phase(cfg["port"], cfg["window"], cfg["timeout_s"]))
    print(json.dumps({"requests": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
