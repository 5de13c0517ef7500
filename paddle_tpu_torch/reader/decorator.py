"""The cancellation handshake of a producer thread and its consumer
(paddle_tpu/reader/decorator.py:93-115, copied): every producer and
consumer pair of the port (``data.feeder.DeviceFeeder``) uses these two
helpers, so the poll interval and the shutdown order are the same
everywhere."""

import queue


def _cancellable_put(q, item, cancel, poll=0.1):
    """Bounded-queue put that gives up when ``cancel`` is set — the
    producer-side half of the abandoned-consumer fix: a worker blocked
    on a full queue must wake up and exit when nobody will ever drain
    it. Returns False when cancelled."""
    while not cancel.is_set():
        try:
            q.put(item, timeout=poll)
            return True
        except queue.Full:
            continue
    return False


def _drain(q):
    """Free producer slots so a blocked put wakes within one poll."""
    try:
        while True:
            q.get_nowait()
    except queue.Empty:
        pass
