"""Serving: bundle export/load, the dynamic-batching engine, the
continuous-batching scheduler with its session tier, streaming generation,
multi-model routing, replica fleets (threads or worker processes), the
remote session store and the HTTP front end (paddle_tpu/serve).

The import split is the JAX package's: this module and everything
``load_bundle`` reaches stay free of the graph machinery, and
``export_bundle`` / ``verify_bundle`` (which build the graph) load on
first use.
"""

from paddle_tpu_torch.serve.bundle import (Bundle, BundleReplica, is_bundle,
                                           load_bundle, pad_rows)
from paddle_tpu_torch.serve.engine import InferenceEngine, Overloaded
from paddle_tpu_torch.serve.fleet import ReplicaSet
from paddle_tpu_torch.serve.generate import generate
from paddle_tpu_torch.serve.router import Router
from paddle_tpu_torch.serve.scheduler import ContinuousScheduler
from paddle_tpu_torch.serve.server import (make_router_server, make_server,
                                           serve_in_thread,
                                           serve_router_in_thread)
from paddle_tpu_torch.serve.sessions import (ConsistentHashRing, SessionGone,
                                             SessionStore)
from paddle_tpu_torch.serve.workers import WorkerSet


def __getattr__(name):
    if name in ("export_bundle", "verify_bundle"):
        from paddle_tpu_torch.serve import export as _export

        return getattr(_export, name)
    raise AttributeError("module 'paddle_tpu_torch.serve' has no attribute "
                         "%r" % name)


__all__ = ["Bundle", "BundleReplica", "ConsistentHashRing",
           "ContinuousScheduler", "InferenceEngine", "Overloaded",
           "ReplicaSet", "Router", "SessionGone", "SessionStore",
           "WorkerSet", "export_bundle", "generate", "is_bundle",
           "load_bundle", "verify_bundle"]
