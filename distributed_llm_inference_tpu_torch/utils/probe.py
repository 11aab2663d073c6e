"""Device liveness probing for the /workers health sweep (the JAX
package's utils/probe.py, on torch).

The source system's /workers polls each worker's /health over HTTP with a
5 s timeout and reports online / offline / error. The port's one stage is
an in-process device, so the equivalent probe is a tiny timed device op:
round-trip one scalar through the device and report how long it took. A
wedged device (a hung stream, a lost card) is reported "offline" after the
timeout instead of hanging the health endpoint.
"""

from __future__ import annotations

import threading
import time

import torch


def _round_trip(dev):
    """One scalar to the device, one add there, and back to the host (the
    `.item()` waits for the add on the device's current stream)."""
    x = torch.ones((), dtype=torch.int32).to(dev)
    return int((x + 1).item())


def probe_device(dev, timeout_s: float = 5.0, _op=None) -> dict:
    """One device's liveness: {"status": online|offline|error, ...}.

    online  -> includes probe_ms (scalar round-trip time)
    error   -> the op raised; includes the error string
    offline -> the op did not complete within timeout_s (probe thread is
               abandoned — it cannot be killed, but it is daemonic)
    """
    result: dict = {}

    def run():
        try:
            t0 = time.perf_counter()
            if _op is not None:
                _op()
            else:
                _round_trip(torch.device(dev))
            result.update(
                status="online",
                probe_ms=round((time.perf_counter() - t0) * 1e3, 2),
            )
        except Exception as e:  # noqa: BLE001 - health must not raise
            result.update(status="error", error=str(e)[:300])

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout_s)
    if not result:
        return {
            "status": "offline",
            "error": f"device probe timed out after {timeout_s:.1f}s",
        }
    return result
