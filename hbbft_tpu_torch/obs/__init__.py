"""Flight recorder: cross-node epoch tracing.

* :mod:`hbbft_tpu_torch.obs.trace` — a bounded per-node ring of structured
  protocol events (:class:`TraceBuffer`) plus the thread-local tracer
  the Python protocol modules emit through (a no-op when no tracer is
  installed, so VirtualNet simulations and unit tests pay one attribute
  lookup per milestone).
* :mod:`hbbft_tpu_torch.obs.export` — merges per-node rings on the shared
  wall clock into Chrome trace-event JSON and per-epoch phase-latency
  summaries.
* :mod:`hbbft_tpu_torch.obs.analyze` — the consensus critical-path
  analyzer and live stall diagnostician over the same rings.

* :mod:`hbbft_tpu_torch.obs.server` — the live scrape endpoints of a
  running cluster (``/metrics``, ``/trace.json``, ``/healthz``,
  ``/diag``).

Copy of ``hbbft_tpu/obs/``.

Re-exports resolve LAZILY (PEP 562), as in the reference: every protocol
module does ``from hbbft_tpu_torch.obs import trace`` on import.
"""

from typing import Any

_EXPORTS = {
    "TraceBuffer": "hbbft_tpu_torch.obs.trace",
    "TraceEvent": "hbbft_tpu_torch.obs.trace",
    "chrome_trace": "hbbft_tpu_torch.obs.export",
    "phase_spans": "hbbft_tpu_torch.obs.export",
    "phase_summaries": "hbbft_tpu_torch.obs.export",
    "write_chrome_trace": "hbbft_tpu_torch.obs.export",
    "critical_path": "hbbft_tpu_torch.obs.analyze",
    "summarize_critical_paths": "hbbft_tpu_torch.obs.analyze",
    "diagnose": "hbbft_tpu_torch.obs.analyze",
    "merge_diags": "hbbft_tpu_torch.obs.analyze",
    "derived_summaries": "hbbft_tpu_torch.obs.analyze",
    "tracks_from_chrome": "hbbft_tpu_torch.obs.analyze",
    "ObsServer": "hbbft_tpu_torch.obs.server",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str) -> Any:
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(target), name)
