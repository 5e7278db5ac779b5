"""Engine drivers (``repro.serve.scenarios``). Slice 1 ports the
offline scenario; server, single- and multi-stream come later."""
from __future__ import annotations

from repro_torch.serve.metrics import ServeReport


def run_offline(engine, requests) -> ServeReport:
    """Offline scenario: the whole workload is available at step 0;
    measures batched throughput."""
    for r in requests:
        r.arrival_step = 0
        engine.submit(r)
    return engine.run()
