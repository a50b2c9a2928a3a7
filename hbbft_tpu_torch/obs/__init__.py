"""Flight recorder: cross-node epoch tracing.

* :mod:`hbbft_tpu_torch.obs.trace` — a bounded per-node ring of structured
  protocol events (:class:`TraceBuffer`) plus the thread-local tracer
  the Python protocol modules emit through (a no-op when no tracer is
  installed, so VirtualNet simulations and unit tests pay one attribute
  lookup per milestone).

Copy of the part of ``hbbft_tpu/obs/`` that the protocols import; the
exporters, the scrape server and the analyzer are not part of this
package yet.

Re-exports resolve LAZILY (PEP 562), as in the reference: every protocol
module does ``from hbbft_tpu_torch.obs import trace`` on import.
"""

from typing import Any

_EXPORTS = {
    "TraceBuffer": "hbbft_tpu_torch.obs.trace",
    "TraceEvent": "hbbft_tpu_torch.obs.trace",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str) -> Any:
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(target), name)
